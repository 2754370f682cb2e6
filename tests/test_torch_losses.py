"""The trainers' metric glue (train/losses.py) against the JAX package's
``train/losses.py`` on the CPU.

Bars: ``batch_lines`` draws sample b's lines from the uniforms that JAX's
split keys give sample b (``jax.random.uniform(split(key, B)[b], (4,
ROUNDS * n))``), equals the port's ``resample_lines`` per sample exactly,
takes the same radius as JAX within 1e-6 relative, and fills as many lines
as JAX within 10% (the resampler's knife-edge labels differ between XLA:CPU
and the port: tests/test_torch_lines.py). ``_metric_batch`` and
``_metric_batch_rt`` on JAX's lines: per-sample values within 1e-4
relative, gradients within 5e-4 relative L2, after asserting equal stage-1
counts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import geometry as JG
from a_robust_registration_loss_tpu.ops import metric as JM
from a_robust_registration_loss_tpu.se3 import se3 as JSE3
from a_robust_registration_loss_tpu.train import losses as JLS
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.train import losses as LS
from torch_port_helpers import neighs, sphere_cloud, t

torch.set_num_threads(1)
B, N_LINES, F = 2, 200, 150


@pytest.fixture(scope="module")
def data():
    """A DCP-style batch: B source/target clouds, their FPS + 3-NN
    neighbourhoods (the (B, N*3, 3) buffers), target boxes and centres,
    JAX's lines at radius scale 0.5, and B small row-convention twists."""
    rng = np.random.default_rng(17)
    src = np.stack([sphere_cloud(320, rng, noise=0.01) for _ in range(B)])
    tar = np.stack([sphere_cloud(330, rng, noise=0.01) for _ in range(B)])
    nbuf = [np.stack([neighs(c, F).reshape(-1, 3) for c in x]) for x in (src, tar)]
    tar_box = np.asarray(JG.bounding_box_corners(jnp.asarray(tar)))
    centers = tar.mean(1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    lines = np.asarray(JLS.batch_lines(key, jnp.asarray(tar_box), jnp.asarray(centers),
                                       N_LINES, jnp.asarray(src), jnp.asarray(tar),
                                       radius_scale=0.5))
    twists = jnp.asarray([[0.03, -0.02, 0.04, 0.01, -0.02, 0.0],
                          [-0.01, 0.02, 0.03, 0.0, 0.01, -0.02]])
    Rs, ts = jax.vmap(JSE3.exp3)(twists)
    return dict(src=src, tar=tar, nsrc=nbuf[0], ntar=nbuf[1], tar_box=tar_box,
                centers=centers, key=key, lines=lines, R=np.asarray(Rs), t=np.asarray(ts))


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_batch_lines_takes_jax_split_uniforms(data):
    keys = jax.random.split(data["key"], B)
    u4 = np.stack([np.asarray(jax.random.uniform(k, (4, LN.ROUNDS * N_LINES))) for k in keys])
    got = LS.batch_lines(t(u4), t(data["tar_box"]), t(data["centers"]), N_LINES,
                         t(data["src"]), t(data["tar"]), radius_scale=0.5)
    assert got.shape == (B, N_LINES, 6)
    box = t(data["tar_box"])
    radius = 0.5 * torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
    radius_j = 0.5 * np.asarray(jnp.linalg.norm(
        jnp.asarray(data["tar_box"])[:, 0] - jnp.asarray(data["tar_box"])[:, -1], axis=-1))
    np.testing.assert_allclose(radius.numpy(), radius_j, rtol=1e-6)
    for b in range(B):
        one = LN.resample_lines(t(u4[b]), radius[b], t(data["centers"][b]),
                                N_LINES, t(data["src"][b]), t(data["tar"][b]))
        assert torch.equal(got[b], one)
        filled = int((got[b].abs().sum(-1) > 0).sum())
        filled_j = int((np.abs(data["lines"][b]).sum(-1) > 0).sum())
        assert filled > 0.5 * N_LINES and abs(filled - filled_j) <= 0.1 * filled_j


def test_batch_lines_is_one_batched_call_without_gradient(data, monkeypatch):
    """The whole batch goes through the candidate stage in one call (one
    kernel launch on a card), and line sampling carries no gradient."""
    from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS

    calls = []
    real = RS.sample_and_hit
    monkeypatch.setattr(RS, "sample_and_hit",
                        lambda u4, *a: calls.append(tuple(u4.shape)) or real(u4, *a))
    u4 = torch.rand((B, 4, LN.ROUNDS * N_LINES), generator=torch.Generator().manual_seed(2))
    src = t(data["src"]).requires_grad_(True)
    lines = LS.batch_lines(u4, t(data["tar_box"]), t(data["centers"]), N_LINES, src,
                           t(data["tar"]), radius_scale=0.5)
    assert calls == [(B, 4, LN.ROUNDS * N_LINES)]
    assert lines.shape == (B, N_LINES, 6) and not lines.requires_grad


def test_flat_neis_and_config(data):
    flat = LS._flat_neis(t(data["nsrc"]))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(JLS._flat_neis(jnp.asarray(data["nsrc"]))))
    assert flat.shape == (B, F, 9)
    for kmin, kmax in ((0, 4), (3, 2)):
        with pytest.raises(ValueError):
            LS.LossConfig(kmin=kmin, kmax=kmax)
    assert LS.LossConfig().n_lines == JLS.LossConfig().n_lines


def _counts_agree(neis1, neis2, lines):
    for b in range(B):
        for n in (neis1[b], neis2[b]):
            ref = JM.find_intersections(jnp.asarray(n), jnp.asarray(lines[b]))
            np.testing.assert_array_equal(
                M.find_intersections(t(n), t(lines[b])).count.numpy(), np.asarray(ref.count))


def test_metric_batch_matches_jax(data):
    """Per-sample metric of the transformed source neighbourhoods and its
    gradient with respect to them."""
    nsrc = np.asarray(JLS._flat_neis(jnp.asarray(data["nsrc"])))
    ntar = np.asarray(JLS._flat_neis(jnp.asarray(data["ntar"])))
    nsrc_t = np.einsum("bfkj,bji->bfki", nsrc.reshape(B, F, 3, 3), data["R"])
    nsrc_t = (nsrc_t + data["t"][:, None, None, :]).reshape(B, F, 9).astype(np.float32)
    _counts_agree(nsrc_t, ntar, data["lines"])
    jcfg = JLS.LossConfig(line_chunk=None)
    vj, gj = jax.value_and_grad(
        lambda a: jnp.sum(JLS._metric_batch(a, jnp.asarray(ntar), jnp.asarray(data["lines"]),
                                            jcfg) * jnp.asarray([1.0, 2.0])))(jnp.asarray(nsrc_t))
    per_j = JLS._metric_batch(jnp.asarray(nsrc_t), jnp.asarray(ntar), jnp.asarray(data["lines"]),
                              jcfg)
    a = t(nsrc_t).requires_grad_(True)
    per = LS._metric_batch(a, t(ntar), t(data["lines"]), LS.LossConfig())
    (g,) = torch.autograd.grad((per * torch.tensor([1.0, 2.0])).sum(), a)
    assert per.shape == (B,) and bool((per > 0).all())
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(per_j), rtol=1e-4)
    assert _rel_l2(g.numpy(), np.asarray(gj)) <= 5e-4


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_metric_batch_rt_matches_jax(data, backend):
    """The batched rigid metric against JAX's _metric_batch_rt (XLA) and
    a vmap of the JAX Pallas rigid path (interpret mode): per-sample values
    and the gradient with respect to every sample's (R, t)."""
    nsrc = np.asarray(JLS._flat_neis(jnp.asarray(data["nsrc"])))
    ntar = np.asarray(JLS._flat_neis(jnp.asarray(data["ntar"])))
    lines, R, tr = data["lines"], data["R"], data["t"]
    if backend == "xla":
        def jf(R_, t_):
            return JLS._metric_batch_rt(R_, t_, jnp.asarray(nsrc), jnp.asarray(ntar),
                                        jnp.asarray(lines), JLS.LossConfig(line_chunk=None))
    else:
        def jf(R_, t_):
            def per(Rb, tb, a, b, ln):
                loss, valid = JM.intersection_loss_rigid(Rb, tb, a, b, ln, backend="pallas",
                                                         interpret=True)
                return jnp.where(valid, loss, 0.0)
            return jax.vmap(per)(R_, t_, jnp.asarray(nsrc), jnp.asarray(ntar), jnp.asarray(lines))
    wts = jnp.asarray([1.0, 2.0])
    per_j = jf(jnp.asarray(R), jnp.asarray(tr))
    gRj, gtj = jax.grad(lambda a, b: jnp.sum(jf(a, b) * wts), argnums=(0, 1))(
        jnp.asarray(R), jnp.asarray(tr))
    _, _, c1, c2 = M.rigid_slots(t(R), t(tr), t(nsrc), t(ntar), t(lines), 4)
    for b in range(B):  # precondition: the port labels as JAX's rigid path does
        _, _, c1j, c2j = JM._rigid_slots_lanemajor(
            jnp.asarray(R[b]), jnp.asarray(tr[b]), jnp.asarray(nsrc[b]),
            jnp.asarray(ntar[b]), jnp.asarray(lines[b]), 4, True)
        np.testing.assert_array_equal(c1[b].numpy(), np.asarray(c1j)[:N_LINES])
        np.testing.assert_array_equal(c2[b].numpy(), np.asarray(c2j)[:N_LINES])
    Rt, tt = t(R).requires_grad_(True), t(tr).requires_grad_(True)
    per = LS._metric_batch_rt(Rt, tt, t(nsrc), t(ntar), t(lines), LS.LossConfig())
    gR, gt = torch.autograd.grad((per * torch.tensor([1.0, 2.0])).sum(), (Rt, tt))
    assert per.shape == (B,) and bool((per > 0).all())
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(per_j), rtol=1e-4)
    got = np.concatenate([gR.numpy().ravel(), gt.numpy().ravel()])
    want = np.concatenate([np.ravel(gRj), np.ravel(gtj)])
    assert _rel_l2(got, want) <= 5e-4


def test_invalid_sample_contributes_zero(data):
    """A sample whose lines all miss gives 0 and no gradient; the other
    sample is unaffected."""
    nsrc = t(data["nsrc"]).reshape(B, F, 9)
    ntar = t(data["ntar"]).reshape(B, F, 9)
    lines = t(data["lines"]).clone()
    lines[1, :, 3:] += 100.0
    R = torch.eye(3).repeat(B, 1, 1).requires_grad_(True)
    tt = torch.zeros(B, 3, requires_grad=True)
    per = LS._metric_batch_rt(R, tt, nsrc, ntar, lines, LS.LossConfig())
    gR, _ = torch.autograd.grad(per.sum(), (R, tt))
    one, valid = M.intersection_loss_rigid(torch.eye(3), torch.zeros(3), nsrc[0], ntar[0], lines[0])
    assert float(per[1].detach()) == 0.0 and float(gR[1].abs().sum()) == 0.0
    assert bool(valid) and torch.equal(per[0].detach(), one)
