"""FMR (models/fmr.py, train/losses.py:fmr_train_loss, train/fmr.py) against
the JAX package's, on the CPU, at dim_k 64, N = 64 points, maxiter 3.

Both sides hold the same weights (a perturbed Flax tree carried by
``fmr_from_flax``) and see the same lines: the port draws them from the
JAX uniforms and the JAX loss takes exactly those (``batch_lines``
patched in the test, as test_torch_dcp_train.py does: XLA:CPU and the port
label knife-edge candidates differently).

The finite-difference Jacobian amplifies the features' rounding about
1 / dt = 100 times, and each IC iterate carries it on: both sides' fp32
solves are about 1e-4 from the float64 solve of the same weights at
maxiter 3, in different directions, and a difference of 1e-4 in the
iterates flips a few knife-edge stage-1 hits (3 of 1,536 slots here),
which moves the metric by 3e-3 relative. So the loss composition is held
on the same iterates, and the solver on its own. Bars, set from the errors
these seeds give (in brackets, measured):

- the solver: every iterate of g within 5e-4 absolute of JAX's [3.3e-5 at
  maxiter 1, 1.7e-4 at 3], and no farther from the port's own float64
  solve than twice JAX's distance to it [port 8.5e-5, JAX 1.1e-4]; r
  within 2e-3 relative L2 [5.4e-4]; loss_ende within 1e-5 relative [0];
  the gradient of a fixed linear function of g_series plus 0.01 loss_ende
  to all parameters within 5e-3 relative L2 of JAX's [1.9e-3], and no
  farther from the float64 gradient than three times JAX's [1.8e-3, JAX
  1.0e-3];
- ``fmr_train_loss`` on JAX's iterates: the total and every part within
  1e-4 relative [0], its gradient to the iterates within 5e-4 relative L2
  [7.8e-7];
- two train steps in lockstep (each side on its own iterates) at lr 1e-5
  and the eval step: every metric within 1e-3 relative or 2e-5 absolute
  [4.9e-4 relative, loss_chamfer]. At lr 1e-3 the second step is apart by
  up to 1.7e-2: Adam turns the first gradient's rounding noise into steps
  of +-lr, and the second step's iterates flip other hits;
- ``evaluate``'s twist rows within 5e-4 absolute, the bar of g [1.9e-4],
  and the mean dm within 1e-3 relative [1.3e-4].
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.models import fmr as JF
from a_robust_registration_loss_tpu.train import fmr as JTF
from a_robust_registration_loss_tpu.train import losses as JLS
from a_robust_registration_loss_tpu_torch.models import fmr as F
from a_robust_registration_loss_tpu_torch.models.transplant import (
    adam_from_optax,
    fmr_from_flax,
)
from a_robust_registration_loss_tpu_torch.train import fmr as TF
from a_robust_registration_loss_tpu_torch.train import harness as H
from a_robust_registration_loss_tpu_torch.train import losses as LS
from torch_port_helpers import jax_uniforms, make_batch, perturbed, t

torch.set_num_threads(1)
B, N, DIM_K, MAXITER, N_LINES, LR = 2, 64, 64, 3, 256, 1e-5


def fmr_batch(seed=0, B=B, N=N):
    """``make_batch`` in the FMR form: row-convention R and T (tar ~= src @ R
    + T) and igt = [[R, -R T], [0, 1]], as the dataset's FMR adapter gives
    them."""
    b = make_batch(B=B, N=N, F=32, seed=seed, rot=0.2)
    R = np.ascontiguousarray(b["R"].transpose(0, 2, 1))
    igt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    igt[:, :3, :3] = R
    igt[:, :3, 3] = -np.einsum("bij,bj->bi", R, b["T"])
    b.update(R=R, R_inv=np.ascontiguousarray(R.transpose(0, 2, 1)), igt=igt)
    return b


@pytest.fixture(scope="module")
def batch():
    return fmr_batch()


def _cfgs():
    model = dict(dim_k=DIM_K, num_points=N, maxiter=MAXITER)
    cfg = TF.FMRTrainConfig(lr=LR, train_maxiter=MAXITER, eval_maxiter=MAXITER + 1,
                            loss=LS.LossConfig(n_lines=N_LINES), model=F.FMRConfig(**model))
    jcfg = JTF.FMRTrainConfig(lr=LR, train_maxiter=MAXITER, eval_maxiter=MAXITER + 1,
                              loss=JLS.LossConfig(n_lines=N_LINES, line_chunk=None),
                              model=JF.FMRConfig(**model))
    return cfg, jcfg


@pytest.fixture(scope="module")
def nets(batch):
    """(cfg, jcfg, the JAX model, its perturbed params, the port's module
    with the same weights)."""
    cfg, jcfg = _cfgs()
    jm = JF.SolveRegistration(jcfg.model)
    p0, p1 = jnp.asarray(batch["points_tar_sample"]), jnp.asarray(batch["points_src_sample"])
    init = jax.jit(jm.init, static_argnames="maxiter")
    params = perturbed(init(jax.random.PRNGKey(1), p0, p1, maxiter=1)["params"], 1, scale=0.05)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    m = F.SolveRegistration(cfg.model)
    m.load_state_dict(fmr_from_flax(params))
    return cfg, jcfg, jm, params, m


@pytest.fixture
def shared_lines(monkeypatch):
    """Records the port's lines and makes a JAX function take them as its
    last argument, returned by the JAX package's ``batch_lines``."""
    seen, traced = [], {}
    real = LS.batch_lines

    def record(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    def with_lines(fn):
        def run(*args):
            traced["lines"] = args[-1]
            return fn(*args[:-1])
        return jax.jit(run)

    monkeypatch.setattr(LS, "batch_lines", record)
    monkeypatch.setattr(JLS, "batch_lines", lambda *a, **k: traced["lines"])
    return seen, with_lines


def _tb(batch):
    return {k: t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _apply(jm):
    return jax.jit(jm.apply, static_argnames="maxiter")


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def test_state_dict_names_are_the_reference_fmr(nets):
    _, _, _, params, m = nets
    sd = m.state_dict()
    assert sd["encoder.h1.0.weight"].shape == (64, 3, 1)
    assert sd["encoder.h2.6.weight"].shape == (DIM_K, 128, 1)
    assert sd["encoder.h2.7.bias"].shape == (DIM_K,)
    assert sd["decoder.fc4.weight"].shape == (3 * N, DIM_K // 4)
    assert sd["decoder.bn3.weight"].shape == (DIM_K // 4,)
    assert sd["dt"].shape == (1, 6)
    m2 = F.SolveRegistration(m.cfg)
    m2.load_state_dict({**sd, "dt": sd["dt"].reshape(6)})  # the reference's (6,) dt
    assert torch.equal(m2.dt, sd["dt"])
    no_dec = {k: v for k, v in params.items() if k != "decoder"}
    assert not any(k.startswith("decoder.") for k in fmr_from_flax(no_dec))


@pytest.mark.parametrize("maxiter", [1, MAXITER])
def test_solver_matches_jax(batch, nets, maxiter):
    _, _, jm, params, m = nets
    want = _apply(jm)(
        {"params": params}, jnp.asarray(batch["points_tar_sample"]),
        jnp.asarray(batch["points_src_sample"]), maxiter=maxiter)
    with torch.no_grad():
        got = m(t(batch["points_tar_sample"]), t(batch["points_src_sample"]), maxiter=maxiter)
        m64 = F.SolveRegistration(m.cfg).double()
        m64.load_state_dict({k: v.double() for k, v in m.state_dict().items()})
        exact = m64(t(batch["points_tar_sample"]).double(),
                    t(batch["points_src_sample"]).double(), maxiter=maxiter)["g_series"].numpy()
    assert got["g_series"].shape == (maxiter, B, 4, 4)
    np.testing.assert_array_equal(got["g"].numpy(), got["g_series"][-1].numpy())
    np.testing.assert_allclose(got["g_series"].numpy(), np.asarray(want["g_series"]), atol=5e-4)
    port_err = np.abs(got["g_series"].numpy() - exact).max()
    jax_err = np.abs(np.asarray(want["g_series"]) - exact).max()
    assert port_err <= 2 * jax_err + 1e-6, (port_err, jax_err)
    assert _rel(got["r"].numpy(), want["r"]) <= 2e-3
    np.testing.assert_allclose(float(got["loss_ende"]), float(want["loss_ende"]), rtol=1e-5)
    assert int(got["n_singular"]) == int(want["n_singular"]) == 0
    assert not np.allclose(got["g"].numpy(), np.eye(4), atol=1e-3)  # the solve moved


def test_degenerate_and_nan_clouds(batch, nets):
    """The Jacobian is taken on the target: with every point of both clouds
    on one line, rotation about it moves no point, H is singular, every
    sample is counted and its g stays the identity, without an exception,
    as in the JAX package. A NaN in one target makes that sample's H
    non-finite: counted, and its g NaN on both sides."""
    _, _, jm, params, m = nets
    line = np.zeros((B, N, 3), np.float32)
    line[..., 0] = np.linspace(-0.5, 0.5, N, dtype=np.float32)
    poisoned = batch["points_tar_sample"].copy()
    poisoned[1, 3, 0] = np.nan
    for p0, p1, n_sing in ((line, line, B), (poisoned, batch["points_src_sample"], 1)):
        want = _apply(jm)({"params": params}, jnp.asarray(p0), jnp.asarray(p1), maxiter=MAXITER)
        with torch.no_grad():
            got = m(t(p0), t(p1), maxiter=MAXITER)
        assert int(got["n_singular"]) == int(want["n_singular"]) == n_sing
        g, wg = got["g"].numpy(), np.asarray(want["g"])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(wg))
        ok = ~np.isnan(wg).any(axis=(1, 2))
        np.testing.assert_allclose(g[ok], wg[ok], atol=5e-4)
    np.testing.assert_allclose(m(t(line), t(line), maxiter=2)["g"].detach().numpy(),
                               np.broadcast_to(np.eye(4), (B, 4, 4)), atol=1e-7)


def test_solver_gradient_matches_jax(batch, nets):
    _, _, jm, params, m = nets
    cot = np.random.default_rng(0).standard_normal((MAXITER, B, 4, 4)).astype(np.float32)

    def jf(p):
        o = jm.apply({"params": p}, jnp.asarray(batch["points_tar_sample"]),
                     jnp.asarray(batch["points_src_sample"]), maxiter=MAXITER)
        return jnp.sum(o["g_series"] * cot) + 0.01 * o["loss_ende"]

    want = fmr_from_flax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(jf))(params)))
    m64 = F.SolveRegistration(m.cfg).double()
    m64.load_state_dict({k: v.double() for k, v in m.state_dict().items()})
    flat = []
    for net, dtype in ((m, torch.float32), (m64, torch.float64)):
        o = net(t(batch["points_tar_sample"]).to(dtype), t(batch["points_src_sample"]).to(dtype),
                maxiter=MAXITER)
        f = (o["g_series"] * t(cot).to(dtype)).sum() + 0.01 * o["loss_ende"]
        flat.append(torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            f, list(net.parameters()))]).double().numpy())
    got, exact = flat
    want = np.concatenate([want[n].reshape(-1).double().numpy() for n, _ in m.named_parameters()])
    assert _rel(got, want) <= 5e-3
    assert _rel(got, exact) <= 3 * _rel(want, exact), (_rel(got, exact), _rel(want, exact))


def test_train_loss_matches_jax_on_the_same_iterates(batch, nets, shared_lines):
    cfg, jcfg, jm, params, _ = nets
    seen, with_lines = shared_lines
    key = jax.random.PRNGKey(4)
    jb = _jb(batch)
    jout = _apply(jm)({"params": params}, jb["points_tar_sample"], jb["points_src_sample"],
                      maxiter=MAXITER)
    g_series = t(np.asarray(jout["g_series"])).requires_grad_(True)
    total, parts = LS.fmr_train_loss(g_series, t(np.asarray(jout["loss_ende"])), _tb(batch),
                                     cfg.loss, MAXITER, u4=t(jax_uniforms(key, B, N_LINES)))
    (grad,) = torch.autograd.grad(total, g_series)
    fn = with_lines(jax.value_and_grad(
        lambda gs: JLS.fmr_train_loss(gs, jout["loss_ende"], jb, key, jcfg.loss,
                                      maxiter=MAXITER), has_aux=True))
    (jtotal, jparts), jgrad = fn(jout["g_series"], jnp.asarray(seen[-1].numpy()))
    assert float(parts["loss_intersection"]) > 0
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-4)
    assert set(parts) == set(jparts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-4, err_msg=k)
    assert _rel(grad.numpy(), jgrad) <= 5e-4


def test_train_and_eval_steps_match_jax(batch, nets, shared_lines):
    cfg, jcfg, jm, params, m0 = nets
    seen, with_lines = shared_lines
    m = F.SolveRegistration(cfg.model)
    m.load_state_dict(m0.state_dict())
    _, optimizer, jstep, jeval, _ = JTF.make_steps(jcfg)
    jstep = with_lines(jstep)
    jstate = optimizer.init(params)
    names = [k for k, _ in m.named_parameters()]
    adam = jstate[0]
    state = adam_from_optax(jax.tree_util.tree_map(np.asarray, (adam.count, adam.mu, adam.nu)),
                            names, from_flax=fmr_from_flax)
    for k in range(2):
        key = jax.random.PRNGKey(20 + k)
        state, got = TF.train_step(m, state, _tb(batch), cfg,
                                   u4=t(jax_uniforms(key, B, N_LINES)))
        params, jstate, want = jstep(params, jstate, _jb(batch), key,
                                     jnp.asarray(seen[-1].numpy()))
        assert set(got) == set(want) and float(got["nonfinite_steps"]) == 0.0
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-3,
                                       atol=2e-5, err_msg=f"step {k} {name}")
        assert int(state.count) == int(jstate[0].count) == k + 1
    with torch.no_grad():
        got = TF.eval_step(m, _tb(batch), cfg)
    want = jax.jit(jeval)(params, _jb(batch), jax.random.PRNGKey(0))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-3, atol=2e-5,
                                   err_msg=name)


def test_nan_batch_is_skipped(batch):
    cfg, _ = _cfgs()
    m = TF.init_model(cfg, 0, device="cpu")
    state = H.adam_init(m.parameters())
    gen = torch.Generator().manual_seed(1)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    poisoned = _tb(batch)
    poisoned["points_src_sample"][0, 0, 0] = float("nan")
    after, metrics = TF.train_step(m, state, poisoned, cfg, generator=gen)
    assert float(metrics["nonfinite_steps"]) == 1.0
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())
    assert all(torch.equal(a, b) for a, b in zip(after, state))
    after, metrics = TF.train_step(m, after, _tb(batch), cfg, generator=gen)
    assert float(metrics["nonfinite_steps"]) == 0.0 and int(after.count) == 1


def test_evaluate_rows_match_jax(tmp_path, nets):
    """``evaluate``'s CSV rows and mean dm against the JAX package's on the
    same batches, plain and with both ablations (the same numpy draws)."""
    cfg, jcfg, _, params, m = nets
    batches = [{k: v[:1] for k, v in fmr_batch(seed=s).items()} for s in (3, 4)]
    for kw in ({}, {"add_noise": True, "add_density": True}):
        mine, theirs = tmp_path / f"port{len(kw)}", tmp_path / f"jax{len(kw)}"
        dm = TF.evaluate(cfg, m.state_dict(), batches, str(mine), log=lambda s: None,
                         device="cpu", seed=3, save_objs=not kw, **kw)
        jdm = JTF.evaluate(jcfg, params, batches, str(theirs), log=lambda s: None, seed=3, **kw)
        np.testing.assert_allclose(dm, jdm, rtol=1e-3)
        rows = np.loadtxt(mine / "eval_twists.csv", delimiter=",", skiprows=1)
        jrows = np.loadtxt(theirs / "eval_twists.csv", delimiter=",", skiprows=1)
        assert rows.shape == jrows.shape == (2, 12)
        np.testing.assert_allclose(rows, jrows, atol=5e-4)
        with open(mine / "eval_twists.csv") as f:
            assert f.readline().strip() == JF_HEADER
    names = set(os.listdir(tmp_path / "port0"))
    assert {f"pair1_{k}.obj" for k in ("src", "pred_src", "tar", "gt_src")} <= names
    assert {"source_pre.ply", "source.ply", "target.ply", "registration.png"} <= set(
        os.listdir(tmp_path / "port0" / "pair1_viz"))


JF_HEADER = "h_w1,h_w2,h_w3,h_v1,h_v2,h_v3,g_w1,g_w2,g_w3,g_v1,g_v2,g_v3"


@pytest.mark.parametrize("noise,density", [(True, False), (False, True), (True, True)])
def test_ablate_batch_matches_jax(batch, noise, density):
    got = TF.ablate_batch(batch, np.random.default_rng(5), noise, density)
    want = JTF.ablate_batch(batch, np.random.default_rng(5), noise, density)
    np.testing.assert_array_equal(got["points_src_sample"], want["points_src_sample"])
    np.testing.assert_array_equal(got["points_tar_sample"], want["points_tar_sample"])
