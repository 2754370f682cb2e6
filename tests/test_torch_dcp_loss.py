"""DCP's loss composition and evaluation path (train/losses.py, train/dcp.py)
against the JAX package's, on the CPU, on a ``make_batch`` batch.

Both sides get the JAX draw of uniforms, but not the same lines from it: the
resampler's accept test is a rounding knife edge, and XLA:CPU and the port
label a share of the candidates differently (tests/test_torch_lines.py). So
the port runs first with the JAX uniforms, its lines are recorded, and the
JAX functions are handed exactly those lines (``batch_lines`` patched in the
test). Equal stage-1 counts are asserted before any value is compared.

Bars: loss within 1e-4 relative; every monitor within 1e-5; the gradient
with respect to (R_ab, t_ab) within 5e-4 relative L2; the gradient with
respect to the network's parameters through the whole model within 2e-3
relative L2 over the concatenated tree; ``eval_step`` the same keys and
values within 1e-4; ``evaluate`` the same ``Eval.json`` keys, values within
1e-4 except ``loss_intersection``, which each side takes on its own lines
(within 5%).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.models import dcp as JD
from a_robust_registration_loss_tpu.ops import metric as JM
from a_robust_registration_loss_tpu.se3 import se3 as JSE3
from a_robust_registration_loss_tpu.train import dcp as JTD
from a_robust_registration_loss_tpu.train import losses as JLS
from a_robust_registration_loss_tpu_torch.models import dcp as D
from a_robust_registration_loss_tpu_torch.models.transplant import dcp_from_flax
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.train import dcp as TD
from a_robust_registration_loss_tpu_torch.train import losses as LS
from torch_port_helpers import jax_uniforms, make_batch, perturbed, t

torch.set_num_threads(1)
B, N_LINES = 2, 256
MODEL = dict(emb_nn="dgcnn", pointer="transformer", head="svd", emb_dims=32, ff_dims=64,
             dgcnn_k=8)
KEY = jax.random.PRNGKey(5)


@pytest.fixture(scope="module")
def batch():
    return make_batch(B=B, N=48, F=24)


@pytest.fixture(scope="module")
def nets(batch):
    """(flax model, its perturbed params, the port's module with the same
    weights)."""
    src, tar = jnp.asarray(batch["points_src_sample"]), jnp.asarray(batch["points_tar_sample"])
    jm = JD.DCP(JD.DCPConfig(**MODEL))
    params = perturbed(jm.init(jax.random.PRNGKey(1), src, tar)["params"], 1, scale=0.05)
    m = D.DCP(D.DCPConfig(**MODEL))
    m.load_state_dict(dcp_from_flax(params))
    return jm, params, m


@pytest.fixture
def shared_lines(monkeypatch):
    """Records the port's ``batch_lines`` output and hands it to the JAX
    package in place of its own resampling."""
    seen = []
    real = LS.batch_lines

    def record(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(LS, "batch_lines", record)
    monkeypatch.setattr(JLS, "batch_lines", lambda *a, **k: jnp.asarray(seen[-1].numpy()))
    return seen


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: t(v) for k, v in batch.items()}


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _assert_counts_agree(batch, R, tr, lines):
    """Precondition of every comparison: both sides label the same
    intersections on the transformed source and on the target."""
    nsrc = batch["points_based_neighs_src"].reshape(B, -1, 3, 3)
    nsrc = (np.einsum("bij,bfkj->bfki", R, nsrc) + tr[:, None, None]).reshape(B, -1, 9)
    ntar = batch["points_based_neighs_tar"].reshape(B, -1, 9)
    total = 0
    for b in range(B):
        for n in (nsrc[b].astype(np.float32), ntar[b]):
            want = np.asarray(JM.find_intersections(jnp.asarray(n), jnp.asarray(lines[b])).count)
            got = M.find_intersections(t(n), t(lines[b])).count.numpy()
            np.testing.assert_array_equal(got, want)
            total += int(got.sum())
    assert total > 0


def _assert_monitors(got, want, atol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=atol,
                                   err_msg=k)


def _small_pose():
    Rs, ts = jax.vmap(JSE3.exp3)(jnp.asarray([[0.03, -0.02, 0.24, 0.04, -0.02, 0.0],
                                               [-0.01, 0.02, 0.26, 0.05, -0.01, 0.02]]))
    # column convention: the batch's R is the transpose of its row rotation
    return np.asarray(Rs).transpose(0, 2, 1).copy(), np.asarray(ts)


@pytest.mark.parametrize("cycle", [False, True], ids=["plain", "cycle"])
def test_train_loss_value_monitors_and_pose_gradient(batch, shared_lines, cycle):
    R, tr = _small_pose()
    R_ba, t_ba = R.transpose(0, 2, 1) + 0.01, -tr + 0.01
    u4 = t(jax_uniforms(KEY, B, N_LINES))
    Rt, tt = t(R).requires_grad_(True), t(tr).requires_grad_(True)
    loss, mon = LS.dcp_train_loss(_tb(batch), Rt, tt, t(R_ba), t(t_ba),
                                  LS.LossConfig(n_lines=N_LINES, cycle=cycle), u4=u4)
    gR, gt = torch.autograd.grad(loss, (Rt, tt))
    assert len(shared_lines) == 1 and shared_lines[0].shape == (B, N_LINES, 6)
    assert not any(v.requires_grad for v in mon.values())
    _assert_counts_agree(batch, R, tr, shared_lines[0].numpy())

    jcfg = JLS.LossConfig(n_lines=N_LINES, line_chunk=None, cycle=cycle)

    def jf(R_, t_):
        return JLS.dcp_train_loss(_jb(batch), R_, t_, jnp.asarray(R_ba), jnp.asarray(t_ba),
                                  KEY, jcfg)

    (want, jmon), (gRj, gtj) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(R), jnp.asarray(tr))
    assert float(want) > 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    _assert_monitors(mon, jmon)
    assert ("cycle_loss" in mon) == cycle
    got = np.concatenate([gR.numpy().ravel(), gt.numpy().ravel()])
    assert _rel_l2(got, np.concatenate([np.ravel(gRj), np.ravel(gtj)])) <= 5e-4


def test_cal_loss_alone_and_its_helpers(batch, shared_lines):
    R, tr = _small_pose()
    u4 = t(jax_uniforms(KEY, B, N_LINES))
    loss, mon = LS.dcp_cal_loss(_tb(batch), t(R), t(tr), LS.LossConfig(n_lines=N_LINES), u4=u4)
    want, jmon = JLS.dcp_cal_loss(_jb(batch), jnp.asarray(R), jnp.asarray(tr), KEY,
                                  JLS.LossConfig(n_lines=N_LINES, line_chunk=None))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    _assert_monitors(mon, jmon)
    pts = batch["points_src_sample"]
    np.testing.assert_allclose(LS.dcp_transform(t(pts), t(R), t(tr)).numpy(),
                               np.asarray(JLS.dcp_transform(jnp.asarray(pts), jnp.asarray(R),
                                                            jnp.asarray(tr))), atol=1e-6)
    args = (R, tr, R.transpose(0, 2, 1) + 0.02, -tr + 0.03)
    np.testing.assert_allclose(float(LS.dcp_cycle_loss(*map(t, args))),
                               float(JLS.dcp_cycle_loss(*map(jnp.asarray, args))), atol=1e-6)


def test_gradient_through_the_network(batch, nets, shared_lines):
    """Forward and gradient of dcp_train_loss through the whole model to
    every parameter."""
    jm, params, m = nets
    u4 = t(jax_uniforms(KEY, B, N_LINES))
    tb = _tb(batch)
    out = TD.forward(m, tb)
    loss, _ = LS.dcp_train_loss(tb, *out, LS.LossConfig(n_lines=N_LINES), u4=u4)
    names = [k for k, _ in m.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(m.parameters()))))
    _assert_counts_agree(batch, out[0].detach().numpy(), out[1].detach().numpy(),
                         shared_lines[0].numpy())

    def jf(p):
        o = jm.apply({"params": p}, jnp.asarray(batch["points_src_sample"]),
                     jnp.asarray(batch["points_tar_sample"]))
        return JLS.dcp_train_loss(_jb(batch), *o, KEY,
                                  JLS.LossConfig(n_lines=N_LINES, line_chunk=None))[0]

    want, gj = jax.value_and_grad(jf)(jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    gj = dcp_from_flax(gj)  # the name map is linear: it carries gradients too
    assert set(names) == set(gj) - {"head.reflect"}
    got = np.concatenate([grads[k].numpy().ravel() for k in names])
    ref = np.concatenate([gj[k].numpy().ravel() for k in names])
    assert np.isfinite(got).all() and np.linalg.norm(ref) > 0
    assert _rel_l2(got, ref) <= 2e-3


def test_eval_step_matches_jax(batch, nets, shared_lines):
    jm, params, m = nets
    u4 = t(jax_uniforms(KEY, B, N_LINES))
    for cycle in (False, True):
        cfg = TD.DCPTrainConfig(loss=LS.LossConfig(n_lines=N_LINES, cycle=cycle),
                                model=D.DCPConfig(**MODEL))
        with torch.no_grad():
            got = TD.eval_step(m, _tb(batch), cfg, u4=u4)
        jcfg = JTD.DCPTrainConfig(
            loss=JLS.LossConfig(n_lines=N_LINES, line_chunk=None, cycle=cycle),
            model=JD.DCPConfig(**MODEL))
        want = JTD.make_steps(jcfg)[3](jax.tree_util.tree_map(jnp.asarray, params),
                                       _jb(batch), KEY)
        _assert_monitors(got, want, atol=1e-4)
    src, pred, tar, gt = TD.artifact_fn(m, _tb(batch))
    want = JTD.make_steps(jcfg)[5](jax.tree_util.tree_map(jnp.asarray, params), _jb(batch), KEY)
    for g, w in zip((src, pred, tar, gt), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5)


def test_evaluate_writes_the_same_summary(batch, nets, tmp_path):
    jm, params, m = nets
    loader = [batch, make_batch(B=B, N=48, F=24, seed=3, rot=0.2)]
    cfg = TD.DCPTrainConfig(loss=LS.LossConfig(n_lines=N_LINES), model=D.DCPConfig(**MODEL))
    logs = []
    got = TD.evaluate(cfg, m.state_dict(), loader, str(tmp_path / "port"), log=logs.append,
                      epoch=3, device="cpu")
    jcfg = JTD.DCPTrainConfig(loss=JLS.LossConfig(n_lines=N_LINES, line_chunk=None),
                              model=JD.DCPConfig(**MODEL))
    want = JTD.evaluate(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                        [_jb(b) for b in loader], str(tmp_path / "jax"), log=lambda m: None,
                        epoch=3)
    with open(tmp_path / "port" / "Eval.json") as f:
        on_disk = json.load(f)
    assert on_disk == got and set(got) == set(want)
    for k in want:
        tol = dict(rtol=5e-2) if k == "loss_intersection" else dict(rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert "3_3src_gt.obj" in os.listdir(tmp_path / "port")
    assert len(logs) == 3 and logs[-1].startswith("EVAL loss=")
    with pytest.raises(ValueError):
        TD.evaluate(cfg, m.state_dict(), [], str(tmp_path / "none"), device="cpu")


def test_uniforms_come_from_the_generator_when_not_given(batch):
    R, tr = _small_pose()
    cfg = LS.LossConfig(n_lines=64)
    u4 = LS.draw_uniforms(B, 64, "cpu", torch.Generator().manual_seed(9))
    assert u4.shape == (B, 4, LN.ROUNDS * 64)
    a, _ = LS.dcp_cal_loss(_tb(batch), t(R), t(tr), cfg, u4=u4)
    b, _ = LS.dcp_cal_loss(_tb(batch), t(R), t(tr), cfg,
                           generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and float(a) > 0
