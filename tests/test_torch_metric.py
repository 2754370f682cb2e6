"""The port's rigid metric (ops/metric.py) against the JAX package.

Bars: loss within 1e-4 relative and gradient with respect to (R, t) within
5e-4 relative L2 of ``intersection_loss_rigid`` on both JAX backends
(backend="pallas" in interpret mode, and backend="xla"); stage 2 on
identical slot inputs within 1e-6 relative; the masked median exactly;
Welsch and the adaptive threshold within 1e-7 absolute / 1e-6 relative
(XLA:CPU fuses multiply-adds into FMAs and has its own exp; the port rounds
every operation on its own).

The metric is discontinuous in the stage-1 labels: one line whose count
changes can move a (k, j) combo in or out and the loss by percent. A label
whose d2 lies within an FMA rounding of its threshold can flip between
XLA:CPU and the port (seen at another seed), so the loss test first
asserts that both sides' stage-1 counts agree on its problem. ``sqrt_rn``,
the port's square root wherever a label depends on the last bit, equals
numpy's IEEE float32 square root exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import metric as JM
from a_robust_registration_loss_tpu.se3 import se3 as JSE3
from a_robust_registration_loss_tpu_torch._device import sqrt_rn
from a_robust_registration_loss_tpu_torch.ops import metric as M
from torch_port_helpers import random_problem, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    return random_problem(seed=7, f1=333, f2=301, n_lines=257)


def test_neighborhood_delta(problem):
    neis1 = problem[0]
    np.testing.assert_allclose(M.neighborhood_delta(t(neis1)).numpy(),
                               np.asarray(JM.neighborhood_delta(jnp.asarray(neis1))),
                               rtol=1e-6, atol=0)
    neis4 = np.random.default_rng(0).standard_normal((30, 12)).astype(np.float32)
    np.testing.assert_allclose(M.neighborhood_delta(t(neis4)).numpy(),
                               np.asarray(JM.neighborhood_delta(jnp.asarray(neis4))),
                               rtol=1e-6, atol=0)


def test_welsch_and_masked_median():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 2, (50, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(M.welsch(t(x), 0.3).numpy(),
                               np.asarray(JM.welsch(jnp.asarray(x), 0.3)),
                               rtol=0, atol=1e-7)
    for p in (0.5, 0.02, 0.0):  # many valid, few valid, none valid
        mask = rng.uniform(size=x.shape) < p
        np.testing.assert_array_equal(
            M._masked_lower_median(t(x), t(mask)).numpy(),
            np.asarray(JM._masked_lower_median(jnp.asarray(x), jnp.asarray(mask))))


def test_stage2_matches_lanemajor_twin():
    """Stage 2 on identical slot points and counts, against the JAX
    lane-major stage 2 that the Pallas path runs."""
    rng = np.random.default_rng(8)
    L, K = 300, 4
    c1 = rng.integers(0, 7, L).astype(np.int32)
    c2 = rng.integers(0, 7, L).astype(np.int32)
    pts1 = rng.standard_normal((L, K, 3)).astype(np.float32) * 0.1
    pts2 = rng.standard_normal((L, K, 3)).astype(np.float32) * 0.1
    filled1 = np.arange(K)[None] < np.minimum(c1, K)[:, None]
    filled2 = np.arange(K)[None] < np.minimum(c2, K)[:, None]
    pts1 = np.where(filled1[..., None], pts1, 0)
    pts2 = np.where(filled2[..., None], pts2, 0)
    lj, vj = JM._stage2_lanemajor(
        jnp.asarray(pts1.transpose(1, 2, 0).reshape(K * 3, L)),
        jnp.asarray(pts2.transpose(1, 2, 0).reshape(K * 3, L)),
        jnp.asarray(c1), jnp.asarray(c2), 1, K)
    lt, vt = M.stage2(t(pts1), t(pts2), t(c1), t(c2), 1, K)
    assert bool(vt) == bool(vj)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_loss_and_grad_match_jax(problem, backend):
    neis1, neis2, lines = problem
    R, tr = JSE3.exp3(jnp.asarray([0.04, -0.03, 0.06, 0.02, 0.0, -0.01]))

    def jf(R_, t_):
        return JM.intersection_loss_rigid(
            R_, t_, jnp.asarray(neis1), jnp.asarray(neis2), jnp.asarray(lines),
            backend=backend, interpret=True)

    # precondition: both sides' stage-1 labels agree on this problem
    _, _, c1j, c2j = JM._rigid_slots_lanemajor(
        R, tr, jnp.asarray(neis1), jnp.asarray(neis2), jnp.asarray(lines), 4,
        True)
    _, _, c1, c2 = M.rigid_slots(t(R), t(tr), t(neis1), t(neis2), t(lines), 4)
    L = lines.shape[0]
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c1j)[:L])
    np.testing.assert_array_equal(c2.numpy(), np.asarray(c2j)[:L])

    lj, vj = jf(R, tr)
    gRj, gtj = jax.grad(lambda a, b: jf(a, b)[0], argnums=(0, 1))(R, tr)
    Rt = t(R).requires_grad_(True)
    tt = t(tr).requires_grad_(True)
    lt, vt = M.intersection_loss_rigid(Rt, tt, t(neis1), t(neis2), t(lines))
    gR, gt = torch.autograd.grad(lt, (Rt, tt))
    assert bool(vj) and bool(vt)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    gj = np.concatenate([np.ravel(gRj), np.ravel(gtj)])
    gp = np.concatenate([gR.numpy().ravel(), gt.numpy().ravel()])
    assert np.isfinite(gp).all()
    assert np.linalg.norm(gp - gj) / np.linalg.norm(gj) <= 5e-4


def test_no_usable_line_is_invalid(problem):
    neis1, neis2, lines = problem
    far = lines.copy()
    far[:, 3:] += 100.0  # every line misses both clouds
    R = torch.eye(3, requires_grad=True)
    tt = torch.zeros(3, requires_grad=True)
    loss, valid = M.intersection_loss_rigid(R, tt, t(neis1), t(neis2), t(far))
    assert not bool(valid) and float(loss.detach()) == 0.0
    gR, gt = torch.autograd.grad(loss, (R, tt))
    assert float(gR.abs().sum() + gt.abs().sum()) == 0.0


def test_sqrt_rn_is_correctly_rounded():
    rng = np.random.default_rng(12)
    x = np.concatenate([rng.uniform(0, 10, 100_000),
                        10.0 ** rng.uniform(-12, 6, 100_000)]).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(t(x)).numpy(), np.sqrt(x))
