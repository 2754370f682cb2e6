"""RPM-Net's loss (train/losses.py: rpm_cal_loss, rpm_total_loss) and its
training half (train/rpmnet.py) against the JAX package's, on the CPU, at
feat_dim 16, 8 neighbours, N = 64 points, 3 Sinkhorn iterations, B = 2 and
256 lines.

Both sides hold the same weights (a perturbed Flax tree carried by
``rpmnet_from_flax``) and the same Adam state (``adam_from_optax``, both of
optax.adam(schedule)'s counts), see the same lines (the port draws them from
the JAX uniforms and the JAX loss takes exactly those: its ``batch_lines``
patched in the test, as test_torch_dcp_train.py does) and the same ball
queries (the JAX package's ``query_ball_point_excl`` patched to call the
port's on its own inputs: XLA:CPU and PyTorch round d^2 differently at the
radius). Bars: the loss within 1e-4 relative, ``loss_gt`` and
``loss_chamfer`` within 1e-5; the gradient within 5e-4 relative L2: of the
loss to the transforms and Sinkhorn matrices, and of a train and a
pretrain step to every parameter, read from the first moment after one
step from zero moments (mu = (1 - b1) g on both sides). At these weights
the Kabsch covariances' singular values are about 0.018, 0.015 and 0.0034
(no near-equal pair: the SVD's gradient terms 1 / (s_i^2 - s_j^2) stay
below 1e4), and the step's gradients agree to 1.5e-5.
The schedule equals optax's at every count tried, and the handover from
pretraining to training equals the JAX ``train``'s (counts exact, moments
within 5e-4 relative L2), moments carried or fresh. A NaN batch leaves the
module and the optimiser state bitwise unchanged; ``train`` resumes
exactly; ``evaluate`` writes the JAX package's files with its numbers.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from a_robust_registration_loss_tpu.models import rpmnet as JR
from a_robust_registration_loss_tpu.train import harness as JH
from a_robust_registration_loss_tpu.train import losses as JLS
from a_robust_registration_loss_tpu.train import rpmnet as JTR
from a_robust_registration_loss_tpu_torch.models import rpmnet as R
from a_robust_registration_loss_tpu_torch.models.transplant import (
    adam_from_optax,
    rpmnet_from_flax,
)
from a_robust_registration_loss_tpu_torch.train import harness as H
from a_robust_registration_loss_tpu_torch.train import losses as LS
from a_robust_registration_loss_tpu_torch.train import rpmnet as TR
from torch_port_helpers import jax_uniforms, make_batch, perturbed, port_indices_on_jax_inputs, t

torch.set_num_threads(1)
B, N, F, N_LINES, LR = 2, 64, 32, 256, 1e-3
SMALL = dict(feat_dim=16, num_neighbors=8, num_sk_iter=3, radius=0.5)


def rpm_batch(seed=0, B=B):
    """``make_batch`` in the plain contract RPM-Net takes: row-convention R
    (tar = src R + T) and outward unit normals of both clouds."""
    b = make_batch(B=B, N=N, F=F, seed=seed)
    b["R"] = np.ascontiguousarray(b["R"].transpose(0, 2, 1))
    for tag in ("src", "tar"):
        p = b[f"points_{tag}_sample"]
        b[f"normals_{tag}"] = (p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def batch():
    return rpm_batch()


@pytest.fixture
def shared(monkeypatch):
    """The JAX side takes the port's ball queries (on its own inputs) and
    the port's lines. Returns (the port's recorded lines, a wrapper that
    jits a JAX step with the lines as its last argument)."""
    monkeypatch.setattr(JR, "query_ball_point_excl",
                        port_indices_on_jax_inputs(R.query_ball_point_excl))
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


def _configs(**kw):
    cfg = TR.RPMTrainConfig(max_lr=LR, pretrain_lr=LR, loss=LS.LossConfig(n_lines=N_LINES),
                            model=R.RPMNetConfig(**SMALL), **kw)
    jcfg = JTR.RPMTrainConfig(max_lr=LR, pretrain_lr=LR,
                              loss=JLS.LossConfig(n_lines=N_LINES, line_chunk=None),
                              model=JR.RPMNetConfig(**SMALL), **kw)
    return cfg, jcfg


def _nets(batch, **kw):
    """The Flax model's perturbed params, the port's module with the same
    weights, their names, the JAX steps and optimiser."""
    cfg, jcfg = _configs(**kw)
    jm, optimizer, train_step, eval_step, pretrain_step, _ = JTR.make_steps(jcfg)
    params = JTR.init_params(jm, jax.random.PRNGKey(1), _jb(batch))
    params = jax.tree_util.tree_map(jnp.asarray, perturbed(params, 1, scale=0.1))
    m = R.RPMNetEarlyFusion(cfg.model)
    m.load_state_dict(rpmnet_from_flax(params))
    names = [k for k, _ in m.named_parameters()]
    return cfg, jcfg, m, names, params, train_step, pretrain_step, optimizer


def _port_state(opt_state, names):
    return adam_from_optax(jax.tree_util.tree_map(np.asarray, opt_state), names,
                           rpmnet_from_flax)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: t(v) for k, v in batch.items()}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _assert_gradients(m, port_mu, jax_state):
    """Every parameter's first moment, (1 - b1) g after one step from zero
    moments, within 5e-4 relative L2 of JAX's; returns the whole vector's
    relative L2."""
    sizes = [(k, p.numel()) for k, p in m.named_parameters()]
    want = _port_state(jax_state, [k for k, _ in sizes]).adam.mu.numpy()
    got = port_mu.numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    o = 0
    for name, n in sizes:
        g, w = got[o:o + n], want[o:o + n]
        o += n
        assert np.linalg.norm(w) > 0, name
        assert _rel(g, w) <= 5e-4, (name, _rel(g, w))
    return _rel(got, want)


def _random_transforms_and_perms(seed, n_iter=2):
    rng = np.random.default_rng(seed)
    tfs, perms = [], []
    for _ in range(n_iter):
        w = 0.2 * rng.standard_normal((B, 3))
        rot = np.stack([np.asarray(jax.scipy.linalg.expm(jnp.asarray(
            [[0, -x[2], x[1]], [x[2], 0, -x[0]], [-x[1], x[0], 0]], jnp.float32)))
            for x in w])
        tr = 0.05 * rng.standard_normal((B, 3, 1))
        tfs.append(np.concatenate([rot, tr], -1).astype(np.float32))
        la = rng.standard_normal((B, N, N)).astype(np.float32) * 2
        perms.append(np.exp(np.asarray(JR.sinkhorn(jnp.asarray(la), 3, True))))
    return tfs, perms


def test_rpm_loss_matches_jax(batch, shared):
    seen, with_lines = shared
    tfs, perms = _random_transforms_and_perms(0)
    key = jax.random.PRNGKey(5)
    tf_t = [t(x).requires_grad_(True) for x in tfs]
    perm_t = [t(x).requires_grad_(True) for x in perms]
    losses, pred = LS.rpm_cal_loss(tf_t, perm_t, _tb(batch), LS.LossConfig(n_lines=N_LINES),
                                   u4=t(jax_uniforms(key, B, N_LINES)))
    total = LS.rpm_total_loss(losses)
    grads = torch.autograd.grad(total, tf_t + perm_t)
    assert len(seen) == 1

    jcfg = JLS.LossConfig(n_lines=N_LINES, line_chunk=None)

    def jloss(tf, pm):
        def inner(tf, pm):
            lo, pr = JLS.rpm_cal_loss(tf, pm, _jb(batch), key, jcfg)
            return JLS.rpm_total_loss(lo), (lo, pr)
        return jax.value_and_grad(inner, argnums=(0, 1), has_aux=True)(tf, pm)

    (jtotal, (jlosses, jpred)), (gtf, gpm) = with_lines(jloss)(
        [jnp.asarray(x) for x in tfs], [jnp.asarray(x) for x in perms],
        jnp.asarray(seen[0].numpy()))
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-4)
    assert float(losses["loss_intersection"].detach()) > 0
    assert float(losses["loss_reg"].detach()) != 0
    for k in ("loss_intersection", "loss_reg"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4, err_msg=k)
    for k in ("loss_gt", "loss_chamfer"):
        assert not losses[k].requires_grad
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred), atol=1e-6)
    errs = [_rel(g.numpy(), w) for g, w in zip(grads, list(gtf) + list(gpm))]
    print(f"rpm loss gradient rel L2 to the transforms and Sinkhorn matrices: {errs}")
    assert max(errs) <= 5e-4


def test_train_step_matches_jax(batch, shared):
    cfg, _, m, names, params, jstep, _, optimizer = _nets(batch)
    seen, with_lines = shared
    jstep = with_lines(jstep)
    jstate = optimizer.init(params)
    state = _port_state(jstate, names)
    assert isinstance(state, H.ScheduledAdamState) and int(state.count) == 0
    for k in range(2):
        key = jax.random.PRNGKey(10 + k)
        u4 = t(jax_uniforms(key, B, N_LINES))
        state, got = TR.train_step(m, state, _tb(batch), cfg, u4=u4)
        params, jstate, want = jstep(params, jstate, _jb(batch), key,
                                     jnp.asarray(seen[-1].numpy()))
        assert set(got) == set(want) and float(got["nonfinite_steps"]) == 0.0
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4,
                                   err_msg=f"step {k}")
        assert int(state.adam.count) == int(jstate[0].count) == k + 1
        assert int(state.count) == int(jstate[1].count) == k + 1
        if k == 0:
            for key_ in want:
                np.testing.assert_allclose(float(got[key_]), float(want[key_]), rtol=1e-5,
                                           atol=1e-5, err_msg=key_)
            err = _assert_gradients(m, state.adam.mu, jstate)
            print(f"train step gradient rel L2, port against JAX: {err:.3g}; the Kabsch "
                  f"covariances' singular values {kabsch_singular_values(m, batch)}")


def kabsch_singular_values(m, batch):
    """The singular values of each iteration's Kabsch covariance in a
    forward of the train step's 2 iterations, (iter, B, 3) as a list."""
    seen = []
    real = torch.linalg.svd

    def svd(x, *a, **k):
        seen.append(torch.linalg.svdvals(x))
        return real(x, *a, **k)

    with torch.no_grad(), torch.autograd.graph.disable_saved_tensors_hooks("no"), \
            _patched(torch.linalg, "svd", svd):
        TR.forward(m, _tb(batch), 2)
    return np.round(torch.stack(seen).numpy(), 5).tolist()


class _patched:
    def __init__(self, obj, name, value):
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.real = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.real)


def test_pretrain_step_matches_jax(batch, shared):
    cfg, _, m, names, params, _, jstep, optimizer = _nets(batch)
    jstep = jax.jit(jstep)
    jstate = optimizer.init(params)
    state = _port_state(jstate, names)
    for k in range(2):
        state, got = TR.pretrain_step(m, state, _tb(batch), cfg)
        params, jstate, want = jstep(params, jstate, _jb(batch), jax.random.PRNGKey(k))
        assert set(got) == set(want) and float(got["nonfinite_steps"]) == 0.0
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
        assert int(state.adam.count) == int(jstate[0].count) == k + 1
        assert int(state.count) == int(jstate[1].count) == k + 1
        if k == 0:
            err = _assert_gradients(m, state.adam.mu, jstate)
            print(f"pretrain step gradient rel L2, port against JAX: {err:.3g}")


@pytest.mark.parametrize("factors", [(1.0, 1.0), (25.0, 1e4), (10.0, 100.0)])
def test_lr_schedule_matches_optax(factors):
    counts = [0, 1, 99, 100, 50000, 100000, 100001]
    ours = TR.cosine_onecycle_schedule(100000, 2e-5, 0.001, *factors)
    ref = optax.cosine_onecycle_schedule(100000, 2e-5, 0.001, *factors)
    for c in counts:
        got = ours(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(ref(jnp.int32(c))), rtol=1e-6, err_msg=c)
    cfg, jcfg = _configs()
    for c in counts:
        np.testing.assert_allclose(float(TR.lr_schedule(cfg)(torch.tensor(c))),
                                   float(JTR.lr_schedule(jcfg)(jnp.int32(c))), rtol=1e-6)
        assert float(TR.lr_schedule(cfg)(torch.tensor(c))) == np.float32(LR)
    with pytest.raises(ValueError):
        TR.cosine_onecycle_schedule(0, 1e-3)


@pytest.mark.parametrize("carry", [True, False])
def test_pretrain_handover_matches_jax_train(batch, shared, monkeypatch, tmp_path, carry):
    """1 pretrain epoch over 2 batches, then the state the main phase
    starts from: JAX's (caught where its main Trainer.fit receives it)
    against the port's ``train`` with 0 main epochs."""
    batches = [batch, rpm_batch(seed=1)]
    fit = dict(epochs=0, save_every=0, log_tensorboard=False, seed=3)
    cfg, jcfg, m, names, params, *_ = _nets(batch, pretrain_epochs=1,
                                            pretrain_carry_moments=carry)
    jcfg = dataclasses.replace(jcfg, fit=JH.FitConfig(exp_dir=str(tmp_path / "j"), **fit))
    cfg = dataclasses.replace(cfg, fit=H.FitConfig(exp_dir=str(tmp_path / "p"), **fit))
    caught, real_fit = [], JH.Trainer.fit

    def fit_spy(self, params, opt_state, *a, **k):
        caught.append((params, opt_state))
        return real_fit(self, params, opt_state, *a, **k)

    monkeypatch.setattr(JH.Trainer, "fit", fit_spy)
    JTR.train(jcfg, [_jb(b) for b in batches], init_from=params, log=lambda *a: None)
    logs = []
    model, state, hist = TR.train(cfg, [_tb(b) for b in batches], init_from=m.state_dict(),
                                  log=logs.append, device="cpu")
    assert hist == [] and len(caught) == 2  # the pretrain and the main phase
    _, jstate = caught[1]
    want = _port_state(jstate, names)
    assert logs == [] or logs[0].startswith("pretrain epoch 0: loss=")
    assert int(state.count) == int(want.count) == 0
    assert int(state.adam.count) == int(want.adam.count) == (2 if carry else 0)
    if carry:
        assert _rel(state.adam.mu.numpy(), want.adam.mu.numpy()) <= 5e-4
        assert _rel(state.adam.nu.numpy(), want.adam.nu.numpy()) <= 1e-3
    else:
        assert not state.adam.mu.any() and not want.adam.mu.any()
    # the pretrained weights: each moved about lr from the start on both sides
    moved = [float((p - m.state_dict()[k]).abs().max()) for k, p in model.state_dict().items()]
    assert 0.5 * LR < max(moved) < 5 * LR


def test_nan_batch_leaves_model_and_state_unchanged(batch):
    cfg, _ = _configs()
    m = TR.init_model(cfg, 0, device="cpu")
    state = H.scheduled_adam_init(m.parameters())
    gen = torch.Generator().manual_seed(1)
    state, m1 = TR.train_step(m, state, _tb(batch), cfg, generator=gen)
    assert float(m1["nonfinite_steps"]) == 0.0 and int(state.adam.count) == 1
    before = {k: v.clone() for k, v in m.state_dict().items()}
    poisoned = _tb(batch)
    poisoned["points_src_sample"][0, 0, 0] = float("nan")
    after, m2 = TR.train_step(m, state, poisoned, cfg, generator=gen)
    assert float(m2["nonfinite_steps"]) == 1.0
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, b in zip(after.adam + (after.count,), state.adam + (state.count,)):
        assert torch.equal(a, b)
    after, m3 = TR.train_step(m, after, _tb(batch), cfg, generator=gen)
    assert float(m3["nonfinite_steps"]) == 0.0 and int(after.adam.count) == int(after.count) == 2


def test_train_resumes_exactly(tmp_path):
    cfg, _ = _configs(pretrain_epochs=1)
    batches = [rpm_batch(seed=s) for s in range(2)]

    def run(exp, epochs):
        fit = H.FitConfig(epochs=epochs, exp_dir=str(tmp_path / exp), save_every=1,
                          artifacts_every=1, log_tensorboard=False, seed=5)
        logs = []
        out = TR.train(dataclasses.replace(cfg, fit=fit), batches, batches[:1],
                       log=logs.append, device="cpu")
        return out, logs

    (_, _, full), _ = run("full", 3)
    (_, _, first), logs1 = run("int", 2)
    (model, state, second), logs2 = run("int", 3)
    assert [h["epoch"] for h in second] == [2]
    assert second[0] == full[2] and first == full[:2]
    assert logs1[0].startswith("pretrain epoch 0: loss=") and len(logs1) == 3
    assert logs2[0].startswith("pretrain epoch 0: loss=") and logs2[1].startswith("epoch 2:")
    for h in full:
        assert np.isfinite(list(h.values())).all() and h["nonfinite_steps"] == 0.0
        assert {"loss_intersection", "loss_reg", "test_loss", "test_loss_chamfer",
                "test_loss_rot_euler_mae"} <= set(h)
    exp = tmp_path / "int"
    assert sorted(os.listdir(exp / "checkpoints")) == [
        "checkpoints.json", "ckpt-0", "ckpt-1", "ckpt-2", "ckpt-best"]
    assert not os.path.exists(exp / "pretrain" / "checkpoints" / "ckpt-0")
    assert "ep2_gt_src.obj" in os.listdir(exp / "artifacts")
    # Adam's count runs on from the pretraining's 2 steps; the schedule's restarted
    assert int(state.adam.count) == 2 + 3 * len(batches) and int(state.count) == 3 * len(batches)


def test_evaluate_matches_jax(batch, shared, tmp_path):
    cfg, jcfg, m, names, params, *_ = _nets(batch)
    batches = [batch, rpm_batch(seed=2)]
    JTR.evaluate(jcfg, params, [_jb(b) for b in batches], str(tmp_path / "j"),
                 log=lambda *a: None, epoch=7)
    got = TR.evaluate(cfg, m.state_dict(), batches, str(tmp_path / "p"), log=lambda *a: None,
                      epoch=7, device="cpu")
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "p"))
    with open(tmp_path / "j" / "Val.json") as f:
        want = json.load(f)
    with open(tmp_path / "p" / "Val.json") as f:
        assert json.load(f) == got
    assert set(got) == {"loss_chamfer", "loss_gt"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    with torch.no_grad():
        tf = TR.forward(m, _tb(batches[1]), cfg.num_eval_reg_iter)[0][-1]
    for idx in range(2 * B):
        a = np.fromfile(tmp_path / "p" / f"7_pred_src_{idx}.bin", np.float32).reshape(3, 4)
        b = np.fromfile(tmp_path / "j" / f"7_pred_src_{idx}.bin", np.float32).reshape(3, 4)
        np.testing.assert_allclose(a, b, atol=1e-5)
        if idx >= B:  # R stored transposed: the .bin's block is the model's R^T
            np.testing.assert_allclose(a[:, :3], tf[idx - B, :, :3].numpy().T, atol=1e-6)
            np.testing.assert_allclose(a[:, 3], tf[idx - B, :, 3].numpy(), atol=1e-6)
