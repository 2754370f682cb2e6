"""The port's generic metric API (ops/metric.py: find_intersections, the
reconstructions, slot_points_kernel, intersection_loss(_batch,
_transformed, _from_slots), the batched intersection_loss_rigid) against
the JAX package on the CPU, where stage 1 runs its plain version.

Bars:
- find_intersections: counts and slots exactly equal to both JAX paths
  (Pallas in interpret mode, and XLA) at these seeds; slot_w within 1e-6 of
  the XLA path (equal at these seeds) and within 1e-3 of the Pallas path,
  whose interpret-mode d2 carries XLA:CPU's fused multiply-adds: a few ulps
  of |p - x0|^2 ~ 16 in d2 move a weight sqrt(d2 + 2e-4) / sum of a slot
  whose d2 is near 0 (6.8e-4 seen at these seeds).
- losses: value within 1e-4 relative, gradient within 5e-4 relative L2, on
  both JAX backends, after asserting that both sides' stage-1 counts agree
  (the metric is discontinuous in the labels).
- the reconstructions and the slot-points backward on identical records:
  within 1e-6 (JAX's scatter may add in another order).
- batches: equal to per-sample calls bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import metric as JM
from a_robust_registration_loss_tpu.se3 import se3 as JSE3
from a_robust_registration_loss_tpu_torch.ops import metric as M
from torch_port_helpers import random_problem, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    return random_problem(seed=7, f1=300, f2=280, n_lines=257)


@pytest.fixture(scope="module")
def batch():
    """Two samples of one shape (F = 200, 190; L = 250)."""
    probs = [random_problem(seed=s, f1=200, f2=190, n_lines=250) for s in (11, 12)]
    return tuple(np.stack([p[k] for p in probs]) for k in range(3))


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _counts_agree(neis1, neis2, lines):
    """Precondition of a loss test: both sides label every line alike."""
    for n in (neis1, neis2):
        ref = JM.find_intersections(jnp.asarray(n), jnp.asarray(lines))
        np.testing.assert_array_equal(M.find_intersections(t(n), t(lines)).count.numpy(),
                                      np.asarray(ref.count))


@pytest.mark.parametrize("seed", [7, 37])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_find_intersections(seed, backend):
    neis1, _, lines = random_problem(seed=seed)
    got = M.find_intersections(t(neis1), t(lines))
    ref = JM.find_intersections(jnp.asarray(neis1), jnp.asarray(lines),
                                backend=backend, interpret=True)
    assert int(got.count.sum()) > 50
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(got.slot_idx.numpy(), np.asarray(ref.slot_idx))
    np.testing.assert_allclose(got.slot_w.numpy(), np.asarray(ref.slot_w), rtol=0,
                               atol=1e-3 if backend == "pallas" else 1e-6)


def test_find_intersections_batch_is_per_sample(batch):
    neis1, _, lines = batch
    got = M.find_intersections(t(neis1), t(lines))
    for b in range(2):
        one = M.find_intersections(t(neis1[b]), t(lines[b]))
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)


def _jax_inter(neis, lines):
    ref = JM.find_intersections(jnp.asarray(neis), jnp.asarray(lines))
    return ref, M.Intersections(*(t(np.asarray(x)) for x in ref))


def test_reconstructions_match_jax(problem):
    """Both reconstructions on JAX's own record: values and the gradient of
    a fixed projection with respect to the neighbourhoods / the map."""
    neis1, _, lines = problem
    ref, inter = _jax_inter(neis1, lines)
    cot = np.random.default_rng(0).standard_normal(ref.slot_w.shape[:2] + (3,)).astype(np.float32)
    R, tr = JSE3.exp3(jnp.asarray([0.1, -0.2, 0.05, 0.3, 0.0, -0.1]))

    def jf(n):
        return jnp.sum(JM.reconstruct_intersection_points(n, ref) * cot)

    def jf_via(R_, t_):
        return jnp.sum(JM.reconstruct_intersection_points_via(
            jnp.asarray(neis1), ref, lambda p: p @ R_ + t_) * cot)

    n = t(neis1).requires_grad_(True)
    val = (M.reconstruct_intersection_points(n, inter) * t(cot)).sum()
    (gn,) = torch.autograd.grad(val, n)
    Rt, tt = t(R).requires_grad_(True), t(tr).requires_grad_(True)
    val_via = (M.reconstruct_intersection_points_via(
        t(neis1), inter, lambda p: p @ Rt + tt) * t(cot)).sum()
    gR, gt = torch.autograd.grad(val_via, (Rt, tt))
    np.testing.assert_allclose(float(val.detach()), float(jf(jnp.asarray(neis1))), rtol=1e-6)
    np.testing.assert_allclose(gn.numpy(), np.asarray(jax.grad(jf)(jnp.asarray(neis1))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(val_via.detach()), float(jf_via(R, tr)), rtol=1e-6)
    gRj, gtj = jax.grad(jf_via, argnums=(0, 1))(R, tr)
    np.testing.assert_allclose(gR.numpy(), np.asarray(gRj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gtj), rtol=1e-5, atol=1e-5)


def test_slot_points_backward_matches_jax(problem):
    """slot_points_kernel's autograd backward equals JAX's
    _slot_points_kernel_bwd on the same cotangent, and the gather path's
    gradient; its value is the kernel reconstruction it was given."""
    neis1, _, lines = problem
    ref, inter = _jax_inter(neis1, lines)
    rng = np.random.default_rng(1)
    cot = rng.standard_normal(ref.slot_w.shape[:2] + (3,)).astype(np.float32)
    kernel_pts = rng.standard_normal(cot.shape).astype(np.float32)
    gj = JM._slot_points_kernel_bwd((jnp.asarray(neis1), ref.slot_idx, ref.slot_w),
                                    jnp.asarray(cot))[0]
    n = t(neis1).requires_grad_(True)
    out = M.slot_points_kernel(n, t(kernel_pts), inter.slot_idx, inter.slot_w)
    assert torch.equal(out.detach(), t(kernel_pts))
    (g,) = torch.autograd.grad(out, n, t(cot))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=0, atol=1e-6)
    (g_gather,) = torch.autograd.grad(M.reconstruct_intersection_points(n, inter), n, t(cot))
    np.testing.assert_allclose(g.numpy(), g_gather.numpy(), rtol=0, atol=1e-6)


def test_loss_from_slots_matches_jax(problem):
    neis1, neis2, lines = problem
    (r1, i1), (r2, i2) = _jax_inter(neis1, lines), _jax_inter(neis2, lines)
    p1 = JM.reconstruct_intersection_points(jnp.asarray(neis1), r1)
    p2 = JM.reconstruct_intersection_points(jnp.asarray(neis2), r2)
    lj, vj = JM.intersection_loss_from_slots(p1, r1, p2, r2)
    lt, vt = M.intersection_loss_from_slots(t(np.asarray(p1)), i1, t(np.asarray(p2)), i2)
    assert bool(vj) and bool(vt)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_intersection_loss_matches_jax(problem, backend):
    """Value, and the gradient with respect to both clouds."""
    neis1, neis2, lines = problem
    _counts_agree(neis1, neis2, lines)
    jf = jax.value_and_grad(
        lambda a, b: JM.intersection_loss(a, b, jnp.asarray(lines), backend=backend,
                                          interpret=True)[0], argnums=(0, 1))
    lj, (g1j, g2j) = jf(jnp.asarray(neis1), jnp.asarray(neis2))
    a, b = t(neis1).requires_grad_(True), t(neis2).requires_grad_(True)
    lt, vt = M.intersection_loss(a, b, t(lines))
    g1, g2 = torch.autograd.grad(lt, (a, b))
    assert bool(vt)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    assert _rel_l2(g1.numpy(), np.asarray(g1j)) <= 5e-4
    assert _rel_l2(g2.numpy(), np.asarray(g2j)) <= 5e-4


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_intersection_loss_batch_matches_jax(batch, backend):
    """Per-sample values and the gradient of the masked mean (the loss
    microbenchmark's objective) with respect to the source neighbourhoods."""
    neis1, neis2, lines = batch
    for b in range(2):
        _counts_agree(neis1[b], neis2[b], lines[b])

    def jloss(a):
        losses, valid = JM.intersection_loss_batch(a, jnp.asarray(neis2), jnp.asarray(lines),
                                                   backend=backend, interpret=True)
        return jnp.where(valid, losses, 0.0).mean(), losses

    (_, lj), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(neis1))
    a = t(neis1).requires_grad_(True)
    lt, vt = M.intersection_loss_batch(a, t(neis2), t(lines))
    (g,) = torch.autograd.grad(torch.where(vt, lt, 0.0).mean(), a)
    assert lt.shape == (2,) and bool(vt.all())
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=1e-4)
    assert _rel_l2(g.numpy(), np.asarray(gj)) <= 5e-4


def test_intersection_loss_batch_is_per_sample(batch):
    neis1, neis2, lines = batch
    a = t(neis1).requires_grad_(True)
    lt, vt = M.intersection_loss_batch(a, t(neis2), t(lines))
    (g,) = torch.autograd.grad(lt.sum(), a)
    for b in range(2):
        ab = t(neis1[b]).requires_grad_(True)
        l1, v1 = M.intersection_loss(ab, t(neis2[b]), t(lines[b]))
        (g1,) = torch.autograd.grad(l1, ab)
        assert torch.equal(lt[b].detach(), l1.detach()) and bool(vt[b]) == bool(v1)
        assert torch.equal(g[b], g1)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_intersection_loss_transformed_matches_jax(problem, backend):
    """Cloud 1 through p @ R + t: value, gradient with respect to (R, t)
    and to cloud 2; the value equals intersection_loss on the transformed
    cloud."""
    neis1, neis2, lines = problem
    R, tr = JSE3.exp3(jnp.asarray([0.03, -0.02, 0.04, 0.01, -0.02, 0.0]))
    neis1_t = np.asarray((jnp.asarray(neis1).reshape(-1, 3) @ R + tr).reshape(neis1.shape))
    _counts_agree(neis1_t, neis2, lines)

    def jf(R_, t_, b):
        return JM.intersection_loss_transformed(
            lambda p: JM._mm(p, R_) + t_, jnp.asarray(neis1), b, jnp.asarray(lines),
            backend=backend, interpret=True)[0]

    lj, gj = jax.value_and_grad(jf, argnums=(0, 1, 2))(R, tr, jnp.asarray(neis2))
    Rt, tt, b = (t(np.asarray(x)).requires_grad_(True) for x in (R, tr, neis2))
    lt, vt = M.intersection_loss_transformed(lambda p: p @ Rt + tt, t(neis1), b, t(lines))
    g = torch.autograd.grad(lt, (Rt, tt, b))
    assert bool(vt)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    got = np.concatenate([g[0].numpy().ravel(), g[1].numpy().ravel()])
    want = np.concatenate([np.ravel(gj[0]), np.ravel(gj[1])])
    assert _rel_l2(got, want) <= 5e-4
    assert _rel_l2(g[2].numpy(), np.asarray(gj[2])) <= 5e-4
    plain, _ = M.intersection_loss(t(neis1_t), t(neis2), t(lines))
    np.testing.assert_allclose(float(lt.detach()), float(plain), rtol=1e-5)


def test_rigid_batch_is_per_sample(batch):
    """The batched rigid metric equals B unbatched calls: values and the
    gradients with respect to each sample's (R, t)."""
    neis1, neis2, lines = batch
    x = torch.tensor([[0.04, -0.03, 0.06, 0.02, 0.0, -0.01],
                      [-0.02, 0.05, 0.01, 0.0, 0.03, 0.02]])
    from a_robust_registration_loss_tpu_torch.se3 import se3
    R, tr = zip(*(se3.exp3(x[b]) for b in range(2)))
    R = torch.stack(R).requires_grad_(True)
    tr = torch.stack(tr).requires_grad_(True)
    lt, vt = M.intersection_loss_rigid(R, tr, t(neis1), t(neis2), t(lines))
    gR, gt = torch.autograd.grad(lt.sum(), (R, tr))
    assert lt.shape == (2,) and bool(vt.all())
    for b in range(2):
        Rb, tb = R[b].detach().requires_grad_(True), tr[b].detach().requires_grad_(True)
        l1, v1 = M.intersection_loss_rigid(Rb, tb, t(neis1[b]), t(neis2[b]), t(lines[b]))
        g1R, g1t = torch.autograd.grad(l1, (Rb, tb))
        assert torch.equal(lt[b].detach(), l1.detach()) and bool(v1)
        assert torch.equal(gR[b], g1R) and torch.equal(gt[b], g1t)


def test_batched_median_is_per_sample():
    """One lower median per sample, not over the whole batch."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 2, (3, 40, 4, 4)).astype(np.float32)
    mask = rng.uniform(size=x.shape) < np.array([0.5, 0.02, 0.0])[:, None, None, None]
    got = M._masked_lower_median(t(x), t(mask), batch_dims=1)
    for b in range(3):
        assert torch.equal(got[b], M._masked_lower_median(t(x[b]), t(mask[b])))
