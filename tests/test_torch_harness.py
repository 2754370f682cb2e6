"""The port's trainer runtime (train/harness.py) against the JAX package's.

``guarded_update`` matches optax.adam on the same gradients to 1e-6
relative over 5 steps, and on a non-finite loss or gradient (the
welsch(0, 0) NaN of duplicated neighbourhoods, the JAX package's own NaN
source) leaves the parameters, both moments and the count bitwise as they
were, with the flag at 1. ``Trainer.fit`` sums the counter and averages
the rest, logs what the JAX trainer logs, and a run killed after epoch 1
and resumed to 4 epochs gives exactly the losses of an uninterrupted run.
"""

import dataclasses
import json
import os

import numpy as np
import optax
import torch

import jax.numpy as jnp

from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.train import harness as H
from torch_port_helpers import neighs, sphere_cloud, t

torch.set_num_threads(1)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((2, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}


def test_guarded_update_matches_optax_adam():
    lr = 1e-2
    p_np = _params()
    opt = optax.adam(lr)
    pj = {k: jnp.asarray(v) for k, v in p_np.items()}
    sj = opt.init(pj)
    params = [torch.nn.Parameter(t(p_np[k])) for k in ("w", "b")]
    st = H.adam_init(params)
    rng = np.random.default_rng(1)
    for _ in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3 for k, v in p_np.items()}
        u, sj = opt.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, u)
        st, flag = H.guarded_update(lr, [t(g["w"]), t(g["b"])], st, params, torch.tensor(1.0))
        assert float(flag) == 0.0
        for k, p in zip(("w", "b"), params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-7)
        adam = sj[0]
        assert int(st.count) == int(adam.count)
        for got, want in ((st.mu, adam.mu), (st.nu, adam.nu)):
            want = np.concatenate([np.asarray(want[k]).ravel() for k in ("w", "b")])
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _nan_metric_grad():
    """Duplicated neighbourhoods make every slot-point pair coincide: the
    masked median is 0 and welsch(0, 0) = 0/0 = NaN."""
    rng = np.random.default_rng(0)
    pts = sphere_cloud(128, rng)
    neis = t(np.concatenate([neighs(pts, 128)] * 2))
    g = torch.Generator().manual_seed(0)
    lines = LN.resample_lines(torch.rand((4, LN.ROUNDS * 1024), generator=g),
                              torch.tensor(1.8), torch.zeros(3), 1024, t(pts), t(pts))
    tr = torch.zeros(3, requires_grad=True)
    loss, _ = M.intersection_loss_rigid(torch.eye(3), tr, neis, neis, lines)
    (grad,) = torch.autograd.grad(loss, tr)
    return loss.detach(), grad


def test_guarded_update_freezes_on_metric_nan():
    loss, grad = _nan_metric_grad()
    assert not torch.isfinite(loss)  # the quirk fires
    params = [torch.nn.Parameter(torch.tensor([0.1, -0.2, 0.3]))]
    st = H.adam_init(params)
    st, flag0 = H.guarded_update(1e-2, [torch.ones(3)], st, params, torch.tensor(1.0))
    assert float(flag0) == 0.0
    before = params[0].detach().clone()
    new, flag = H.guarded_update(1e-2, [grad], st, params, loss)
    assert float(flag) == 1.0
    assert torch.equal(params[0].detach(), before)
    for a, b in zip(new, st):
        assert torch.equal(a, b)
    # a finite loss with one non-finite gradient element, and a huge but
    # finite gradient that a squared norm would overflow
    g_inf = torch.tensor([1.0, float("inf"), 0.0])
    same, flag = H.guarded_update(1e-2, [g_inf], st, params, torch.tensor(0.5))
    assert float(flag) == 1.0 and torch.equal(params[0].detach(), before)
    assert all(torch.equal(a, b) for a, b in zip(same, st))
    taken, flag = H.guarded_update(1e-2, [torch.full((3,), 3e38)], st, params,
                                   torch.tensor(0.5))
    assert float(flag) == 0.0 and int(taken.count) == int(st.count) + 1


def test_counter_summed_not_averaged(tmp_path):
    def train_step(model, opt_state, batch, gen):
        return opt_state, {"loss": torch.tensor(2.0), "nonfinite_steps": torch.tensor(1.0)}

    cfg = H.FitConfig(epochs=1, exp_dir=str(tmp_path / "cnt"), save_every=0,
                      log_tensorboard=False, resume=False)
    model = torch.nn.Linear(1, 1)
    _, _, history = H.Trainer(train_step, None, cfg, device="cpu").fit(
        model, H.adam_init(model.parameters()), [{"x": np.zeros(1, np.float32)}] * 3,
        log=lambda *a: None)
    assert history[0]["nonfinite_steps"] == 3.0   # summed
    assert history[0]["loss"] == 2.0              # averaged


def _regression(tmp_path, name, epochs, resume=True):
    """A linear model fit by the guarded Adam step on batches whose noise
    comes from the epoch's generator; eval draws from its own."""
    def train_step(model, opt_state, batch, gen):
        x = batch["x"]
        y = x @ torch.tensor([[2.0], [-1.0]]) + 0.1 * torch.randn(x.shape[0], 1, generator=gen)
        loss = ((model(x) - y) ** 2).mean()
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params)
        opt_state, flag = H.guarded_update(0.05, grads, opt_state, params, loss.detach())
        return opt_state, {"loss": loss.detach(), "nonfinite_steps": flag}

    def eval_step(model, batch, gen):
        noise = 0.1 * torch.randn(batch["x"].shape[0], 1, generator=gen)
        return {"loss": ((model(batch["x"]) - noise) ** 2).mean()}

    cfg = H.FitConfig(epochs=epochs, exp_dir=str(tmp_path / name), save_every=1,
                      artifacts_every=2, log_tensorboard=False, resume=resume, seed=7)
    rng = np.random.default_rng(0)
    loader = [{"x": rng.standard_normal((8, 2)).astype(np.float32)} for _ in range(3)]
    torch.manual_seed(0)  # the initial weights only
    model = torch.nn.Linear(2, 1)
    cloud = lambda b: torch.nn.functional.pad(b["x"], (0, 1))  # (8, 3)
    artifacts = lambda m, b: (cloud(b), m(b["x"]).expand(-1, 3), cloud(b), None)
    logs = []
    out = H.Trainer(train_step, eval_step, cfg, artifact_fn=artifacts, device="cpu").fit(
        model, H.adam_init(model.parameters()), loader, loader[:1], log=logs.append)
    return out, logs


def test_kill_and_resume_reproduces_the_losses(tmp_path):
    (_, _, full), _ = _regression(tmp_path, "full", 4, resume=False)
    (_, _, first), _ = _regression(tmp_path, "int", 2)
    (model, opt, second), logs = _regression(tmp_path, "int", 4)
    assert [h["epoch"] for h in first] == [0, 1] and [h["epoch"] for h in second] == [2, 3]
    for h in first + second:
        assert h == {**full[h["epoch"]], "epoch": h["epoch"]}
    assert int(opt.count) == 12
    assert logs[0].startswith("epoch 2: loss=") and " | test: loss=" in logs[0]
    exp = tmp_path / "int"
    assert sorted(os.listdir(exp / "checkpoints")) == [
        "checkpoints.json", "ckpt-0", "ckpt-1", "ckpt-2", "ckpt-3", "ckpt-best"]
    assert sorted(os.listdir(exp / "artifacts")) == [
        "ep0_pred_src.obj", "ep0_src.obj", "ep0_tar.obj",
        "ep2_pred_src.obj", "ep2_src.obj", "ep2_tar.obj"]
    with open(exp / "logs" / "metrics.jsonl") as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("train/loss") == 4 and tags.count("test/loss") == 4
    assert tags.count("time/epoch_seconds") == 4 and "train/nonfinite_steps" in tags


def test_restore_loads_model_and_optimiser(tmp_path):
    (model, opt, _), _ = _regression(tmp_path, "r", 2)
    cfg = H.FitConfig(exp_dir=str(tmp_path / "r"), log_tensorboard=False)
    fresh = torch.nn.Linear(2, 1)
    tr = H.Trainer(lambda *a: None, None, cfg, device="cpu")
    got, start = tr.restore(fresh, H.adam_init(fresh.parameters()))
    assert start == 2
    for a, b in zip(fresh.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(got, opt):
        assert torch.equal(a, b)
    no = H.Trainer(lambda *a: None, None, dataclasses.replace(cfg, resume=False), device="cpu")
    assert no.restore(fresh, "unchanged") == ("unchanged", 0)
