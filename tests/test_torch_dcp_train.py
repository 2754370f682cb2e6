"""DCP's training half (train/dcp.py: train_step, pretrain_step, train;
models/transplant.py: adam_from_optax) against the JAX package's, on the
CPU, on ``make_batch`` batches.

Both sides start from the same weights (``dcp_from_flax``) and the same
Adam state (``adam_from_optax``), at lr 1e-3 so the update is visible, and
see the same lines: the port draws them from the JAX uniforms and the
jitted JAX step takes exactly those as an argument (``batch_lines``
patched in the test to return it, as test_torch_dcp_loss.py hands them
over). Bars: the loss within
1e-4 relative, every monitor within 1e-5; every parameter's gradient
within 5e-4 relative L2, read from the first moment after one step from
zero moments (mu = (1 - b1) g on both sides); the losses of 3 steps within
1e-4 relative (parameters are not compared after a step: Adam turns a
gradient near 0 into a step of about +-lr whose sign is noise). A NaN in
one batch's source cloud leaves the module and the optimiser state
bitwise unchanged. ``train`` runs both phases with checkpoints, metrics,
artifacts and an exact resume.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.models import dcp as JD
from a_robust_registration_loss_tpu.train import dcp as JTD
from a_robust_registration_loss_tpu.train import losses as JLS
from a_robust_registration_loss_tpu_torch.models import dcp as D
from a_robust_registration_loss_tpu_torch.models.transplant import adam_from_optax, dcp_from_flax
from a_robust_registration_loss_tpu_torch.train import dcp as TD
from a_robust_registration_loss_tpu_torch.train import harness as H
from a_robust_registration_loss_tpu_torch.train import losses as LS
from torch_port_helpers import jax_uniforms, make_batch, perturbed, t

torch.set_num_threads(1)
B, N_LINES, LR = 2, 256, 1e-3
MODELS = {
    "pointnet": dict(emb_nn="pointnet", pointer="identity", head="svd", emb_dims=32,
                     ff_dims=64),
    "dgcnn": dict(emb_nn="dgcnn", pointer="transformer", head="svd", emb_dims=32,
                  ff_dims=64, dgcnn_k=8),
}


@pytest.fixture(scope="module")
def batch():
    return make_batch(B=B, N=48, F=24)


@pytest.fixture
def shared_lines(monkeypatch):
    """Records the port's ``batch_lines`` output, and makes a JAX step
    jittable with the lines as its last argument, which the JAX package's
    ``batch_lines`` then returns in place of its own resampling. Returns
    (the recorded lines, the wrapper)."""
    seen, traced = [], {}
    real = LS.batch_lines

    def record(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    def with_lines(step):
        def run(*args):
            traced["lines"] = args[-1]
            return step(*args[:-1])
        return jax.jit(run)

    monkeypatch.setattr(LS, "batch_lines", record)
    monkeypatch.setattr(JLS, "batch_lines", lambda *a, **k: traced["lines"])
    return seen, with_lines


def _configs(name):
    kw = MODELS[name]
    cfg = TD.DCPTrainConfig(lr=LR, pretrain_lr=LR, loss=LS.LossConfig(n_lines=N_LINES),
                            model=D.DCPConfig(**kw))
    jcfg = JTD.DCPTrainConfig(lr=LR, pretrain_lr=LR,
                              loss=JLS.LossConfig(n_lines=N_LINES, line_chunk=None),
                              model=JD.DCPConfig(**kw))
    return cfg, jcfg


def _nets(name, batch):
    """The Flax model's perturbed params and the port's module with the same
    weights, the JAX steps, a fresh optax state and its port counterpart."""
    cfg, jcfg = _configs(name)
    jm, optimizer, train_step, _, pretrain_step, _ = JTD.make_steps(jcfg)
    src, tar = jnp.asarray(batch["points_src_sample"]), jnp.asarray(batch["points_tar_sample"])
    params = perturbed(jm.init(jax.random.PRNGKey(1), src, tar)["params"], 1, scale=0.05)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    m = D.DCP(cfg.model)
    m.load_state_dict(dcp_from_flax(params))
    names = [k for k, _ in m.named_parameters()]
    return cfg, m, names, params, train_step, pretrain_step, optimizer


def _port_adam(opt_state, names):
    adam = opt_state[0]
    return adam_from_optax(jax.tree_util.tree_map(np.asarray, (adam.count, adam.mu, adam.nu)),
                           names)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: t(v) for k, v in batch.items()}


def _assert_gradients(m, names, port_mu, jax_state):
    """Every parameter's first moment, (1 - b1) g after one step from zero
    moments, within 5e-4 relative L2. A parameter whose exact gradient is 0
    (an attention's key bias: the softmax ignores a shift shared by a row's
    scores) holds only rounding noise on both sides, each below 1e-6 of the
    whole gradient's norm."""
    want = _port_adam(jax_state, names).mu.numpy()
    got = port_mu.numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    floor = 1e-6 * np.linalg.norm(want)
    o, zero = 0, []
    for name, p in zip(names, m.parameters()):
        n = p.numel()
        g, w = got[o:o + n], want[o:o + n]
        o += n
        if np.linalg.norm(w) <= floor:
            assert np.linalg.norm(g) <= floor, name
            zero.append(name)
            continue
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 5e-4, name
    assert all(n.endswith("linears.1.bias") for n in zero), zero


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax(batch, shared_lines, name):
    cfg, m, names, params, jstep, _, optimizer = _nets(name, batch)
    seen, with_lines = shared_lines
    jstep = with_lines(jstep)
    jstate = optimizer.init(params)
    state = _port_adam(jstate, names)
    assert state.mu.shape == (sum(p.numel() for p in m.parameters()),)
    for k in range(3):
        key = jax.random.PRNGKey(10 + k)
        state, got = TD.train_step(m, state, _tb(batch), cfg, u4=t(jax_uniforms(key, B, N_LINES)))
        assert len(seen) == k + 1
        params, jstate, want = jstep(params, jstate, _jb(batch), key,
                                     jnp.asarray(seen[-1].numpy()))
        assert set(got) == set(want) and float(got["nonfinite_steps"]) == 0.0
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4,
                                   err_msg=f"step {k}")
        assert float(want["loss"]) > 0
        assert int(state.count) == int(jstate[0].count) == k + 1
        if k == 0:
            for key_ in want:
                np.testing.assert_allclose(float(got[key_]), float(want[key_]), rtol=1e-5,
                                           atol=1e-5, err_msg=key_)
            _assert_gradients(m, names, state.mu, jstate)


@pytest.mark.parametrize("name", list(MODELS))
def test_pretrain_step_matches_jax(batch, name):
    cfg, m, names, params, _, jstep, optimizer = _nets(name, batch)
    jstate = optimizer.init(params)  # a fresh optax.adam state, whatever its lr
    state = _port_adam(jstate, names)
    for k in range(3):
        state, got = TD.pretrain_step(m, state, _tb(batch), cfg)
        params, jstate, want = jstep(params, jstate, _jb(batch), jax.random.PRNGKey(k))
        assert set(got) == set(want)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
        if k == 0:
            for key_ in want:
                np.testing.assert_allclose(float(got[key_]), float(want[key_]), rtol=1e-5,
                                           atol=1e-5, err_msg=key_)
            _assert_gradients(m, names, state.mu, jstate)


def test_nan_batch_leaves_model_and_state_unchanged(batch):
    cfg, _ = _configs("pointnet")
    m = TD.init_model(cfg, 0, device="cpu")
    state = H.adam_init(m.parameters())
    gen = torch.Generator().manual_seed(1)
    state, m1 = TD.train_step(m, state, _tb(batch), cfg, generator=gen)
    assert float(m1["nonfinite_steps"]) == 0.0 and int(state.count) == 1
    before = {k: v.clone() for k, v in m.state_dict().items()}
    poisoned = _tb(batch)
    poisoned["points_src_sample"][0, 0, 0] = float("nan")
    after, m2 = TD.train_step(m, state, poisoned, cfg, generator=gen)
    assert float(m2["nonfinite_steps"]) == 1.0
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, b in zip(after, state):
        assert torch.equal(a, b)
    after, m3 = TD.train_step(m, after, _tb(batch), cfg, generator=gen)
    assert float(m3["nonfinite_steps"]) == 0.0 and int(after.count) == 2
    assert all(torch.isfinite(p).all() for p in m.parameters())


def test_train_both_phases_checkpoints_and_resume(tmp_path):
    cfg, _ = _configs("pointnet")
    batches = [make_batch(B=B, N=48, F=24, seed=s) for s in range(2)]

    def run(exp, epochs):
        fit = H.FitConfig(epochs=epochs, exp_dir=str(tmp_path / exp), save_every=1,
                          artifacts_every=1, log_tensorboard=False, seed=5)
        logs = []
        out = TD.train(dataclasses.replace(cfg, pretrain_epochs=1, fit=fit), batches,
                       batches[:1], log=logs.append, device="cpu")
        return out, logs

    (_, _, full), _ = run("full", 3)
    (_, _, first), logs1 = run("int", 2)
    (model, state, second), logs2 = run("int", 3)
    assert [h["epoch"] for h in second] == [2]
    assert second[0] == full[2] and first == full[:2]
    assert logs1[0].startswith("[pretrain] epoch 0: loss=") and len(logs1) == 3
    assert logs2[0].startswith("epoch 2: loss=") and len(logs2) == 1  # pretrain resumed: done
    for h in full:
        assert np.isfinite(list(h.values())).all() and h["nonfinite_steps"] == 0.0
        assert {"loss_intersection", "test_loss", "test_loss_intersection"} <= set(h)
    exp = tmp_path / "int"
    for d in ("checkpoints", os.path.join("pretrain", "checkpoints")):
        with open(exp / d / "checkpoints.json") as f:
            assert json.load(f)["best_step"] is not None
    assert sorted(os.listdir(exp / "checkpoints")) == [
        "checkpoints.json", "ckpt-0", "ckpt-1", "ckpt-2", "ckpt-best"]
    assert "ep2_gt_src.obj" in os.listdir(exp / "artifacts")
    with open(exp / "logs" / "metrics.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"train/loss", "test/loss_chamfer", "time/epoch_seconds"} <= tags
    assert int(state.count) == 3 * len(batches)
    assert model.state_dict().keys() == D.DCP(cfg.model).state_dict().keys()
