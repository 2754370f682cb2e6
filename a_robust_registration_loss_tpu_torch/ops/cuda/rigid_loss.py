"""The rigid metric after stage 1 and its gradient: the kernels
``csrc/rigid_loss.cu`` and their plain PyTorch version.

``rigid_metric(R, t, count, pts, lines, kmin, kmax)`` takes stage 1's
pts-mode outputs for both clouds (``IK.stage1``'s count (..., 2, L) and
slot points (..., 2, L, kmax, 3, 3)), the lines and (R, t), and returns
(loss, valid) through a ``torch.autograd.Function``. A CUDA tensor launches
the kernels: three for the forward (``rigid_loss``), two for the backward
(``rigid_loss_grad``), each for the whole batch. A CPU tensor runs the
plain version (``rigid_loss_reference``, ``rigid_grad_reference``).
``ops/metric.py:intersection_loss_rigid`` routes a CUDA tensor here; the
CPU path and the line-parallel path keep the ATen code.

The values are those of ``ops/metric.py``'s ``rigid_slots`` after stage 1
and ``stage2``, and the gradient autograd's through them, bit for bit on
the card: the kernels keep the ATen path's arithmetic op for op, the
backward writes out autograd's from the incoming gradient, and every sum
is taken in the order ATen's reduction takes it there (``reduce_order``).
Bit for bit because a gradient that differs in its last bits takes a
1,000-epoch registration, or a trainer's epoch, to another trajectory than
the ATen path's and the benchmark's reference's (``PERF.md``).

Replaces no TPU kernel: the JAX package's stage 2 is XLA's. It is here
because that ATen glue and its backward were about 415 launches of the
classical step's 908, about 0.9 ms of its 1.93 ms (``PERF.md``).

Bound on the H100: bytes (``nbytes``: the slot points, the lines and the
counts read once) over 3.35 TB/s, about 2 us at L = 20,000. The kernels
are bound by latency instead: five dependent passes, the median's barriers
and selects across a cluster, and ATen's sums, whose 512-thread chains the
backward replays. ``chip_smoke.py`` reports the time beside the bound.

Launch counter: ``launches["kernel"]`` counts the forward calls (three
kernels each), ``launches["grad"]`` the backward calls (two each).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from a_robust_registration_loss_tpu_torch.ops.cuda import _build

NNEI = 3
MAX_KMAX = 8       # the kernels' largest kmax, fixed in the .cu
THREADS = 128      # a block's threads and lines in the line passes, fixed in the .cu
STATE = 96         # int32 words a sample the forward leaves for the backward, fixed in the .cu
MAX_CTAS = 1024    # ATen blocks over one sum the sum kernel plays, fixed in the .cu
PART = 328         # int32 partial counts a block of the line pass leaves, fixed in the .cu

launches = _build.launch_counter("rigid_loss")  # "kernel": forward calls, "grad": backward calls


class RigidLoss(NamedTuple):
    """One forward call's results, per sample (no batch axis when the
    inputs had none): the loss, whether it is valid (some line usable), the
    masked lower median of the squared distances, the number of nonempty
    (k, j) combos, and ``state``, what the backward reads (the median and
    the combos' line counts; the kernels' only, None from the plain
    version)."""

    loss: torch.Tensor
    valid: torch.Tensor
    median: torch.Tensor
    n_nonempty: torch.Tensor
    state: Optional[torch.Tensor] = None


def _batched(R, t, count, pts, lines):
    """The inputs with a leading batch axis, and whether they had one."""
    if lines.dim() == 3:
        return (R, t, count, pts, lines), True
    return tuple(x[None] for x in (R, t, count, pts, lines)), False


def _last_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def reduce_order(B: int, n: int, sms: int):
    """How ATen's CUDA reduction splits each of B sums over n contiguous
    float32 values (``x.sum((1, 2), keepdim=True)`` of a (B, L, K) tensor,
    n = L K): (vec, bw, ny, ctas), vec 4-wide loads, a block of bw x ny
    threads over one sum (ny rows when the rows split the input), ctas
    blocks over it. ATen's ``setReduceConfig`` at 512 threads and 4 blocks
    an SM of ``sms``; measured on the card (torch 2.11, H100) equal to
    ``torch.sum`` bit for bit at the cells' shapes, ragged rows and a sum
    that ATen splits over 20 blocks."""
    vec = n > 128
    dim0 = n // 4 if vec else n
    p0 = _last_pow2(dim0) if dim0 < 512 else 512
    p1 = _last_pow2(B) if B < 512 else 512
    bw = min(p0, 32)
    bh = min(p1, 512 // bw)
    bw = min(p0, 512 // bh)
    split_y = _cdiv(n, bw) >= min(bh * 16, 256)
    step = bw * bh if split_y else bw
    ctas = 1
    grid = B if split_y else _cdiv(B, bh)
    target = sms * (2048 // (bw * bh))
    if split_y and _cdiv(n, step) >= 256 and grid <= target:
        per = _cdiv(n, step)
        ctas = max(min(_cdiv(target, grid), _cdiv(per, 16)), _cdiv(per, 256))
    return int(vec), bw, bh if split_y else 1, ctas


def _order(B: int, n: int, dev):
    """``reduce_order`` on the card of ``dev``; raises where it is beyond the
    kernels."""
    order = reduce_order(B, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    if order[3] > MAX_CTAS:
        raise ValueError(f"rigid_loss: a sum over {n} values is beyond the kernels' "
                         f"{MAX_CTAS} blocks")
    return order


def _parts(R, t, count, pts, lines, kmin: int, kmax: int):
    """The ATen path's forward after stage 1, op for op (``rigid_slots``'
    tail, then ``stage2``), on batched detached inputs: its intermediates."""
    # imported here: ops/metric.py imports this module to route a CUDA tensor
    from a_robust_registration_loss_tpu_torch.ops import metric as M

    R, t, pts, lines = (x.detach() for x in (R, t, pts, lines))
    K = kmax
    p1, p2, c1, c2, raw = M._rigid_tail(R, t, count, pts, lines, K)
    filled1, filled2 = M._slot_mask(c1, K), M._slot_mask(c2, K)

    lvalid = (c1 >= kmin) & (c1 <= K) & (c2 >= kmin) & (c2 <= K)
    ok1, ok2 = filled1 & lvalid[..., None], filled2 & lvalid[..., None]
    diff = [p1[:, :, :, None, c] - p2[:, :, None, :, c] for c in range(3)]
    D = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]  # (B, L, K, K)
    median = M._masked_lower_median(D, ok1[..., :, None] & ok2[..., None, :], 1)
    med = median[:, None, None]
    row_in = torch.where(ok2[..., None, :], D, torch.inf)
    col_in = torch.where(ok1[..., :, None], D, torch.inf)
    rowmin, colmin = row_in.amin(dim=-1), col_in.amin(dim=-2)
    nC = K - kmin + 1
    cid = torch.where(lvalid, (c1 - kmin) * nC + (c2 - kmin), nC * nC).long()
    n_combo = torch.zeros((cid.shape[0], nC * nC + 1), dtype=torch.int32, device=c1.device)
    n_combo.scatter_add_(-1, cid, torch.ones_like(cid, dtype=torch.int32))
    n_nonempty = (n_combo[:, :nC * nC] > 0).sum(-1)
    n_line = torch.where(lvalid, n_combo.gather(-1, cid), 1)
    e_r = torch.exp(-(rowmin / med) / 2.0)
    e_c = torch.exp(-(colmin / med) / 2.0)
    row_w = torch.where(ok1, 1.0 - e_r, 0.0)
    col_w = torch.where(ok2, 1.0 - e_c, 0.0)
    row_sum, col_sum = row_w[..., 0], col_w[..., 0]
    for s in range(1, K):
        row_sum = row_sum + row_w[..., s]
        col_sum = col_sum + col_w[..., s]
    den1 = n_line * torch.clamp_min(c1, 1).float()
    den2 = n_line * torch.clamp_min(c2, 1).float()
    w_line = torch.exp(-0.5 * (c1 - c2).abs().float())
    per_line = torch.where(lvalid, w_line * (row_sum / den1 + col_sum / den2), 0.0)
    return dict(raw=raw, filled1=filled1, lvalid=lvalid, ok1=ok1, ok2=ok2, diff=diff,
                median=median, med=med, row_in=row_in, col_in=col_in, rowmin=rowmin,
                colmin=colmin, e_r=e_r, e_c=e_c, den1=den1, den2=den2, w_line=w_line,
                per_line=per_line, n=torch.clamp_min(n_nonempty, 1).float(),
                n_nonempty=n_nonempty)


def rigid_loss_reference(R, t, count, pts, lines, kmin: int, kmax: int) -> RigidLoss:
    """The plain version of ``rigid_loss``, on any device: the ATen path's
    forward op for op, so its loss is that path's bit for bit."""
    (R, t, count, pts, lines), batched = _batched(R, t, count, pts, lines)
    f = _parts(R, t, count, pts, lines, kmin, kmax)
    out = RigidLoss(f["per_line"].sum(-1) / f["n"], f["n_nonempty"] > 0, f["median"],
                    f["n_nonempty"].int())
    return out if batched else RigidLoss(*(x[0] for x in out[:4]))


def rigid_grad_reference(R, t, count, pts, lines, kmin: int, kmax: int, cot):
    """The plain version of ``rigid_loss_grad``: autograd's backward of the
    ATen path written out op for op, from ``cot``, the gradient of the loss
    ((B,) or a scalar without a batch axis) -> (dR, dt). Autograd's bits on
    the device it runs on; the kernels' on the card."""
    (R, t, count, pts, lines), batched = _batched(R, t, count, pts, lines)
    f = _parts(R, t, count, pts, lines, kmin, kmax)
    cot = cot.reshape(-1).to(torch.float32)
    # loss = per_line.sum(-1) / n; per_line = where(lvalid, w_line * (row_sum /
    # den1 + col_sum / den2), 0)
    g_line = torch.where(f["lvalid"], (cot / f["n"])[:, None], 0.0)
    gl = g_line * f["w_line"]
    g_rw = torch.where(f["ok1"], (gl / f["den1"])[..., None], 0.0)
    g_cw = torch.where(f["ok2"], (gl / f["den2"])[..., None], 0.0)
    # Welsch 1 - exp(-(x / median) / 2), backward node by node
    g_rmin = -(((-g_rw) * f["e_r"]) / 2.0) / f["med"]
    g_cmin = -(((-g_cw) * f["e_c"]) / 2.0) / f["med"]
    # amin's: a minimum's gradient shared evenly by its ties
    eq_r = f["row_in"] == f["rowmin"][..., None]
    eq_c = f["col_in"] == f["colmin"][..., None, :]
    g_D = (torch.where(f["ok2"][..., None, :], (g_rmin[..., None] / eq_r.sum(-1, keepdim=True))
                       * eq_r, 0.0)
           + torch.where(f["ok1"][..., :, None], (g_cmin[..., None, :] / eq_c.sum(-2, keepdim=True))
                         * eq_c, 0.0))
    dR = torch.empty((R.shape[0], 3, 3), dtype=torch.float32, device=R.device)
    dt = torch.empty((R.shape[0], 3), dtype=torch.float32, device=R.device)
    for c in range(3):
        d = f["diff"][c]
        g_p1 = (g_D * d + g_D * d).sum(-1)
        g_f = torch.where(f["filled1"], g_p1, 0.0) / NNEI
        for r in range(3):
            dR[:, r, c] = (g_f * f["raw"][r]).sum((1, 2), keepdim=True).reshape(-1)
        dt[:, c] = g_f.sum((1, 2), keepdim=True).reshape(-1)
    return (dR, dt) if batched else (dR[0], dt[0])


def _check(R, t, count, pts, lines, kmin: int, kmax: int):
    """Raise on what the kernels do not take; batched inputs."""
    dev = lines.device
    if dev.type != "cuda":
        raise ValueError(f"rigid_loss: the kernels take CUDA tensors, got {dev}")
    for name, x in (("R", R), ("t", t), ("pts", pts), ("lines", lines)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"rigid_loss: {name} must be float32 on {dev}")
    if count.dtype != torch.int32 or count.device != dev:
        raise ValueError(f"rigid_loss: count must be int32 on {dev}")
    B, L = lines.shape[0], lines.shape[1]
    want = {"R": (B, 3, 3), "t": (B, 3), "count": (B, 2, L), "pts": (B, 2, L, kmax, NNEI, 3),
            "lines": (B, L, 6)}
    for name, x in (("R", R), ("t", t), ("count", count), ("pts", pts), ("lines", lines)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"rigid_loss: {name} must be {want[name]}, got {tuple(x.shape)}")
    if not 1 <= kmin <= kmax <= MAX_KMAX:
        raise ValueError(f"rigid_loss: need 1 <= kmin <= kmax <= {MAX_KMAX}, got {kmin}, {kmax}")
    if not 1 <= B <= 65535 or L < 1 or L * kmax * kmax >= 2**31:
        raise ValueError(f"rigid_loss: B = {B} and L = {L} out of the kernels' range")


def _inputs(R, t, count, pts, lines, kmin: int, kmax: int):
    """Batched, checked, detached and contiguous inputs, and whether they had
    a batch axis."""
    args, batched = _batched(R, t, count, pts, lines)
    _check(*args, kmin, kmax)
    return tuple(x.detach().contiguous() for x in args), batched


def rigid_loss(R, t, count, pts, lines, kmin: int, kmax: int) -> RigidLoss:
    """The forward kernels on CUDA tensors: three launches for the whole
    batch, or a raise. Arguments as ``rigid_metric``'s."""
    (R, t, count, pts, lines), batched = _inputs(R, t, count, pts, lines, kmin, kmax)
    B, L = lines.shape[0], lines.shape[1]
    dev = lines.device
    out = RigidLoss(torch.empty(B, dtype=torch.float32, device=dev),
                    torch.empty(B, dtype=torch.bool, device=dev),
                    torch.empty(B, dtype=torch.float32, device=dev),
                    torch.empty(B, dtype=torch.int32, device=dev),
                    torch.empty((B, STATE), dtype=torch.int32, device=dev))
    keys = torch.empty((B, (L * kmax * kmax + 3) // 4 * 4), dtype=torch.int32, device=dev)
    terms = torch.empty((B, L), dtype=torch.float32, device=dev)
    hparts = torch.empty((B, _cdiv(L, THREADS), PART), dtype=torch.int32, device=dev)
    rc = _build.library().arrl_rigid_loss(
        lines.data_ptr(), count.data_ptr(), pts.data_ptr(), R.data_ptr(), t.data_ptr(),
        B, L, kmax, kmin, keys.data_ptr(), out.state.data_ptr(), terms.data_ptr(),
        hparts.data_ptr(), out.loss.data_ptr(), out.valid.data_ptr(), out.median.data_ptr(),
        out.n_nonempty.data_ptr(), *_order(B, L, dev), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "arrl_rigid_loss")
    launches["kernel"] += 1
    return out if batched else RigidLoss(*(x[0] for x in out[:4]), out.state)


def rigid_loss_grad(R, t, count, pts, lines, kmin: int, kmax: int, state, cot):
    """The backward kernels on CUDA tensors: (dR, dt) of the forward call
    that left ``state``, from ``cot``, the gradient of its loss ((B,) or a
    scalar without a batch axis); two launches, or a raise."""
    (R, t, count, pts, lines), batched = _inputs(R, t, count, pts, lines, kmin, kmax)
    B, L = lines.shape[0], lines.shape[1]
    dev = lines.device
    cot = cot.detach().to(torch.float32).reshape(-1)
    if cot.shape[0] != B or cot.device != dev:
        raise ValueError(f"rigid_loss_grad: the loss's gradient must be ({B},) on {dev}")
    if state.shape != (B, STATE) or state.dtype != torch.int32:
        raise ValueError("rigid_loss_grad: state must be the forward call's")
    plane = (3, (B * L * kmax + 3) // 4 * 4)  # each plane 16-byte aligned
    gf = torch.empty(plane, dtype=torch.float32, device=dev)
    raw = torch.empty(plane, dtype=torch.float32, device=dev)
    dR = torch.empty((B, 3, 3), dtype=torch.float32, device=dev)
    dt = torch.empty((B, 3), dtype=torch.float32, device=dev)
    rc = _build.library().arrl_rigid_loss_grad(
        lines.data_ptr(), count.data_ptr(), pts.data_ptr(), R.data_ptr(), t.data_ptr(),
        B, L, kmax, kmin, state.data_ptr(), cot.data_ptr(), cot.stride(0), gf.data_ptr(),
        raw.data_ptr(), *_order(B, L * kmax, dev), dR.data_ptr(), dt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "arrl_rigid_loss_grad")
    launches["grad"] += 1
    return (dR, dt) if batched else (dR[0], dt[0])


class _RigidMetric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, R, t, count, pts, lines, kmin, kmax):
        R, t = R.detach(), t.detach()
        if lines.device.type == "cpu":
            out = rigid_loss_reference(R, t, count, pts, lines, kmin, kmax)
            ctx.save_for_backward(R, t, count, pts, lines)
        else:
            out = rigid_loss(R, t, count, pts, lines, kmin, kmax)
            ctx.save_for_backward(R, t, count, pts, lines, out.state)
        ctx.k = (kmin, kmax)
        ctx.mark_non_differentiable(out.valid)
        return out.loss, out.valid

    @staticmethod
    def backward(ctx, g_loss, _g_valid):
        saved = ctx.saved_tensors
        if len(saved) == 5:
            dR, dt = rigid_grad_reference(*saved, *ctx.k, g_loss)
        else:
            dR, dt = rigid_loss_grad(*saved[:5], *ctx.k, saved[5], g_loss)
        return dR, dt, None, None, None, None, None


def rigid_metric(R, t, count, pts, lines, kmin: int = 1, kmax: int = 4):
    """(loss, valid) of cloud 1 moved by p @ R + t against cloud 2, from
    stage 1's pts-mode outputs: R (..., 3, 3), t (..., 3), count (..., 2,
    L) int32, pts (..., 2, L, kmax, 3, 3), lines (..., L, 6), one optional
    leading batch axis on all five. The gradient reaches R and t."""
    return _RigidMetric.apply(R, t, count, pts, lines.detach(), kmin, kmax)


def nbytes(B: int, L: int, kmax: int) -> int:
    """Bytes one forward call needs to move: both clouds' slot points, the
    lines and the counts read once (the outputs are a few words a sample)."""
    return B * L * (2 * kmax * NNEI * 3 * 4 + 6 * 4 + 2 * 4)
