"""The rigid metric's written backward (ops/cuda/rigid_loss.py) on the CPU.

``rigid_loss_reference`` and ``rigid_grad_reference`` spell out in PyTorch
the arithmetic of the kernels ``csrc/rigid_loss.cu``: the ATen path's
forward after stage 1 op for op, and autograd's backward of it written out
from the incoming gradient. Here they are held to:

- autograd through ``rigid_slots`` + ``stage2`` (the CPU path): loss,
  validity, median, nonempty combos and the gradient with respect to (R, t)
  equal bit for bit, on the problem fixture of tests/test_torch_metric.py
  (one sample, and a batch of two motions) and on crafted slot records: a
  batch, each sample with its own median, combos and incoming gradient;
  planted ties in row and column minima (amin's backward shares them
  evenly); empty slots and invalid lines; a sample with no usable line
  (valid False, loss and gradient 0); kmin 1 and 2; kmax 2, 3, 4 and 8; and a
  median of exactly 0 (loss and gradient NaN where autograd's are, valid
  True);
- the JAX package's loss and gradient on the problem fixture, both backends,
  within the bars of tests/test_torch_metric.py (1e-4 loss, 5e-4 gradient);
- ``reduce_order``, the split of ATen's CUDA sums the backward replays: the
  splits measured equal to ``torch.sum`` on the card at the cells' shapes.

The kernels run only on the card: tests/test_torch_cuda.py holds them to
these plain versions (and to autograd) bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import metric as JM
from a_robust_registration_loss_tpu.se3 import se3 as JSE3
from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.ops.cuda import rigid_loss as RL
from a_robust_registration_loss_tpu_torch.se3 import se3
from torch_port_helpers import random_problem, t

torch.set_num_threads(1)

TWIST = [0.04, -0.03, 0.06, 0.02, 0.0, -0.01]


@pytest.fixture(scope="module")
def problem():
    return random_problem(seed=7, f1=333, f2=301, n_lines=257)


def crafted(B, L, K, seed, ties=False, invalid_sample=False):
    """Slot records as stage 1 leaves them: counts 0 to K + 2 (empty slots,
    invalid lines), slot points 0 where empty, unit-direction lines, and a
    small motion per sample. ``ties`` makes two slots of each cloud hold the
    same points on a coarse grid, so row and column minima tie;
    ``invalid_sample`` leaves the last sample no usable line."""
    g = torch.Generator().manual_seed(seed)
    count = torch.randint(0, K + 3, (B, 2, L), generator=g, dtype=torch.int32)
    pts = torch.randn((B, 2, L, K, 3, 3), generator=g) * 0.3
    if ties and K > 1:
        pts = torch.round(pts * 8) / 8
        pts[:, :, :, 1] = pts[:, :, :, 0]
    if invalid_sample:
        count[-1] = 0
    filled = torch.arange(K)[None, None, None, :] < torch.clamp_max(count, K)[..., None]
    pts = torch.where(filled[..., None, None], pts, 0.0)
    dirs = torch.randn((B, L, 3), generator=g)
    lines = torch.cat([dirs / dirs.norm(dim=-1, keepdim=True),
                       torch.randn((B, L, 3), generator=g) * 0.2], -1)
    R, tt = se3.exp3(torch.randn((B, 6), generator=g) * 0.1)
    return R, tt, count, pts, lines


def aten(R, tt, count, pts, lines, kmin, K, cot):
    """The CPU path after stage 1 (``rigid_slots``' tail, then ``stage2``)
    with autograd: (loss, valid, dR, dt) of sum(loss * cot)."""
    Rg, tg = R.clone().requires_grad_(True), tt.clone().requires_grad_(True)
    p1, p2, c1, c2, _ = M._rigid_tail(Rg, tg, count, pts, lines, K)
    loss, valid = M.stage2(p1, p2, c1, c2, kmin, K)
    dR, dt = torch.autograd.grad((loss * cot).sum(), (Rg, tg))
    return loss.detach(), valid, dR, dt


def assert_same(a, b):
    """Equal bit for bit, NaN where the other is NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


CASES = {  # (B, L, K, kmin, batched, ties, invalid sample)
    "one_sample": (1, 300, 4, 1, False, False, False),
    "batch": (3, 200, 4, 1, True, False, False),
    "kmin2": (3, 200, 4, 2, True, False, False),
    "ties": (2, 400, 4, 1, True, True, False),
    "ties_kmin2": (2, 400, 4, 2, True, True, False),
    "invalid_sample": (3, 150, 4, 1, True, False, True),
    "kmax2": (2, 100, 2, 1, True, True, False),
    "kmax3": (1, 257, 3, 1, False, True, False),
    "kmax8": (2, 60, 8, 3, True, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_written_backward_is_autograd_bit_for_bit(case):
    B, L, K, kmin, batched, ties, invalid = CASES[case]
    R, tt, count, pts, lines = crafted(B, L, K, 17 + L, ties, invalid)
    cot = torch.rand(B) + 0.5
    if not batched:
        R, tt, count, pts, lines, cot = R[0], tt[0], count[0], pts[0], lines[0], cot[0]
    loss, valid, gR, gt = aten(R, tt, count, pts, lines, kmin, K, cot)
    out = RL.rigid_loss_reference(R, tt, count, pts, lines, kmin, K)
    dR, dt = RL.rigid_grad_reference(R, tt, count, pts, lines, kmin, K, cot)
    assert_same(out.loss, loss)
    assert torch.equal(out.valid, valid)
    assert_same(dR, gR)
    assert_same(dt, gt)
    # the nonempty combos, counted here from the counts
    cb = count if batched else count[None]
    nonempty = torch.tensor([len({(int(x), int(y)) for x, y in zip(cb[b, 0], cb[b, 1])
                                  if kmin <= x <= K and kmin <= y <= K})
                             for b in range(cb.shape[0])], dtype=torch.int32)
    assert torch.equal(out.n_nonempty.reshape(-1), nonempty)
    assert torch.equal(out.valid.reshape(-1), nonempty > 0)
    # the autograd Function: the same values and gradients
    Rf, tf = R.clone().requires_grad_(True), tt.clone().requires_grad_(True)
    lf, vf = RL.rigid_metric(Rf, tf, count, pts, lines, kmin, K)
    gRf, gtf = torch.autograd.grad((lf * cot).sum(), (Rf, tf))
    assert_same(lf.detach(), loss)
    assert torch.equal(vf, valid)
    assert_same(gRf, gR)
    assert_same(gtf, gt)
    if ties:  # the case holds ties in both minima
        f = RL._parts(*(x if batched else x[None] for x in (R, tt, count, pts, lines)), kmin, K)
        row_ties = ((f["row_in"] == f["rowmin"][..., None]).sum(-1) > 1) & f["ok1"]
        col_ties = ((f["col_in"] == f["colmin"][..., None, :]).sum(-2) > 1) & f["ok2"]
        assert int(row_ties.sum()) > 0 and int(col_ties.sum()) > 0


def test_a_sample_with_no_usable_line_gives_zero():
    R, tt, count, pts, lines = crafted(3, 150, 4, 5, invalid_sample=True)
    out = RL.rigid_loss_reference(R, tt, count, pts, lines, 1, 4)
    dR, dt = RL.rigid_grad_reference(R, tt, count, pts, lines, 1, 4, torch.ones(3))
    assert out.valid.tolist() == [True, True, False]
    assert float(out.loss[2]) == 0.0 and int(out.n_nonempty[2]) == 0
    assert float(out.median[2]) == float("inf")
    assert float(dR[2].abs().sum() + dt[2].abs().sum()) == 0.0
    # each sample its own median and combos: the others as if alone
    for b in range(2):
        one = RL.rigid_loss_reference(R[b], tt[b], count[b], pts[b], lines[b], 1, 4)
        assert torch.equal(one.median, out.median[b])
        assert torch.equal(one.n_nonempty, out.n_nonempty[b])
        np.testing.assert_allclose(float(one.loss), float(out.loss[b]), rtol=1e-6)
        gb = RL.rigid_grad_reference(R[b], tt[b], count[b], pts[b], lines[b], 1, 4,
                                     torch.ones(()))
        for got, want in zip(gb, (dR[b], dt[b])):
            assert float((got - want).norm()) <= 1e-6 * float(want.norm())


def test_a_zero_median_makes_the_loss_nan_and_keeps_valid():
    """Every valid pair at distance 0 (cloud 2 a copy of cloud 1, (R, t)
    the identity, one slot a line): the median is 0, the loss and the
    gradient NaN as autograd's, valid True."""
    _, _, count, pts, lines = crafted(1, 200, 4, 9)
    count = torch.ones_like(count)
    pts[:, 1] = pts[:, 0]
    R, tt = torch.eye(3)[None], torch.zeros((1, 3))
    cot = torch.ones(1)
    loss, valid, gR, gt = aten(R, tt, count, pts, lines, 1, 4, cot)
    out = RL.rigid_loss_reference(R, tt, count, pts, lines, 1, 4)
    dR, dt = RL.rigid_grad_reference(R, tt, count, pts, lines, 1, 4, cot)
    assert float(out.median) == 0.0 and bool(out.valid) and bool(torch.isnan(out.loss).all())
    assert bool(torch.isnan(dR).any())
    assert_same(out.loss, loss)
    assert_same(dR, gR)
    assert_same(dt, gt)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_written_path_is_autograd_on_the_problem(problem, batched):
    """Stage 1's own records (``_rigid_stage1``) through ``rigid_metric``
    against ``intersection_loss_rigid``'s CPU path with autograd."""
    neis1, neis2, lines = (t(x) for x in problem)
    twists = torch.tensor([TWIST, [-0.02, 0.05, 0.01, 0.0, 0.03, 0.02]])
    R, tt = se3.exp3(twists)
    if batched:
        neis1, neis2, lines = (torch.stack([x, x]) for x in (neis1, neis2, lines))
    else:
        R, tt = R[0], tt[0]
    count, pts = M._rigid_stage1(R, tt, neis1, neis2, lines, 4)
    Ra, ta = R.clone().requires_grad_(True), tt.clone().requires_grad_(True)
    la, va = M.intersection_loss_rigid(Ra, ta, neis1, neis2, lines)
    gRa, gta = torch.autograd.grad(la.sum(), (Ra, ta))
    Rw, tw = R.clone().requires_grad_(True), tt.clone().requires_grad_(True)
    lw, vw = RL.rigid_metric(Rw, tw, count, pts, lines)
    gRw, gtw = torch.autograd.grad(lw.sum(), (Rw, tw))
    assert bool(va.all()) and torch.equal(vw, va)
    assert torch.equal(lw.detach(), la.detach())
    assert torch.equal(gRw, gRa) and torch.equal(gtw, gta)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_written_path_matches_jax(problem, backend):
    """The written backward against the JAX package's gradient, at the bars
    of tests/test_torch_metric.py (both sides' stage-1 counts agree here)."""
    neis1, neis2, lines = problem
    R, tr = JSE3.exp3(jnp.asarray(TWIST))

    def jf(R_, t_):
        return JM.intersection_loss_rigid(
            R_, t_, jnp.asarray(neis1), jnp.asarray(neis2), jnp.asarray(lines),
            backend=backend, interpret=True)

    lj, vj = jf(R, tr)
    gRj, gtj = jax.grad(lambda a, b: jf(a, b)[0], argnums=(0, 1))(R, tr)
    Rt, tt = t(R).requires_grad_(True), t(tr).requires_grad_(True)
    count, pts = M._rigid_stage1(Rt, tt, t(neis1), t(neis2), t(lines), 4)
    lt, vt = RL.rigid_metric(Rt, tt, count, pts, t(lines))
    gR, gt = torch.autograd.grad(lt, (Rt, tt))
    assert bool(vj) and bool(vt)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    gj = np.concatenate([np.ravel(gRj), np.ravel(gtj)])
    gp = np.concatenate([gR.numpy().ravel(), gt.numpy().ravel()])
    assert np.isfinite(gp).all()
    assert np.linalg.norm(gp - gj) / np.linalg.norm(gj) <= 5e-4


def test_cpu_path_keeps_the_aten_code(problem, monkeypatch):
    """On the CPU ``intersection_loss_rigid`` is ``rigid_slots`` +
    ``stage2``: the written path is never taken there."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path took the written backward")

    monkeypatch.setattr(RL, "rigid_metric", refuse)
    neis1, neis2, lines = (t(x) for x in problem)
    R, tt = se3.exp3(torch.tensor(TWIST))
    loss, valid = M.intersection_loss_rigid(R, tt, neis1, neis2, lines)
    want = M.stage2(*M.rigid_slots(R, tt, neis1, neis2, lines, 4), 1, 4)
    assert torch.equal(loss, want[0]) and torch.equal(valid, want[1])


def test_the_kernels_refuse_a_cpu_tensor():
    R, tt, count, pts, lines = crafted(1, 10, 4, 1)
    with pytest.raises(ValueError):
        RL.rigid_loss(R, tt, count, pts, lines, 1, 4)
    with pytest.raises(ValueError):
        RL.rigid_loss_grad(R, tt, count, pts, lines, 1, 4,
                           torch.zeros((1, RL.STATE), dtype=torch.int32), torch.ones(1))


# (B, n) -> (vec, bw, ny, ctas) on 132 SMs: each measured on the H100 equal to
# torch.sum bit for bit (the sums of the cells' gradients and losses, a ragged
# row, a sum small enough for scalar loads, and one ATen splits over 20 blocks)
ORDERS = {
    (1, 80000): (1, 512, 1, 1), (1, 60000): (1, 512, 1, 1), (1, 40000): (1, 512, 1, 1),
    (1, 20000): (1, 512, 1, 1), (4, 60000): (1, 128, 4, 1), (32, 60000): (1, 32, 16, 1),
    (8, 40000): (1, 64, 8, 1), (16, 40000): (1, 32, 16, 1), (1, 1028): (1, 256, 1, 1),
    (3, 3108): (1, 256, 1, 1), (1, 120): (0, 64, 1, 1), (1, 160000): (1, 512, 1, 20),
    (5, 160000): (1, 128, 4, 20),
}


@pytest.mark.parametrize("shape", list(ORDERS), ids=lambda s: "x".join(map(str, s)))
def test_reduce_order_is_the_measured_split(shape):
    assert RL.reduce_order(*shape, 132) == ORDERS[shape]
