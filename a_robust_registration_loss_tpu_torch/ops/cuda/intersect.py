"""Stage-1 sweep of the robust metric: the kernel ``csrc/intersect.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``a_robust_registration_loss_tpu/ops/pallas/
intersect.py:_kernel`` in every combination of its three output modes, for
one cloud (``intersect_stage1``) or both clouds of a pair against one line
set (``intersect_stage1_pair``; the rigid path calls the raw ``stage1``).
For every (line, neighbourhood) pair:

    d2_i = |p_i - x0|^2 - ((p_i - x0) . dir)^2   (per component, in order)
    hit  = all_i d2_i < thr2,  thr2 = (delta * 1.731/2)^2 - 2e-4

and returns the uncapped hit count per line plus, for the first kmax hit
faces in ascending face order, their index and by mode the raw d2_i
(``emit_d2``), the weighted reconstruction sum_i w_i p_i (``emit_recon``:
w_i = d_i * (1 / sum_j d_j), d_i = sqrt(max(d2_i + 2e-4, 0)), the sum
started from 0) or the gathered neighbour coordinates (``emit_pts``). No
gradient flows through stage 1.

The kernel's design (``csrc/intersect.cu``): a block of 4 warps takes 64
lines and splits the faces into ``SEGMENTS`` = 4 ascending segments, a warp
per segment, a thread sweeping two lines; the sweep keeps only a count and
the first kmax hit indices per (line, segment), the block merges them per
line in segment order (slot k comes from the first segment whose running
count passes k), and the payload (d2, recon, pts) is formed after the sweep
from the stored faces. Split so, a small grid (the classical step's 1,250
warps of lines) still gives every scheduler of the card several short
tasks. Any number of segments gives the same outputs, and
``stage1_reference(..., segments=S)`` is the plain version of the split and
merge.

Every entry takes an optional leading batch axis on all its inputs and
launches the kernel once per call. The public layout is (..., L, kmax, ...)
rather than the TPU's lane-major one. Kernel and plain version agree
exactly; the plain version walks the lines in chunks so that it never holds
an O(L*F) tensor at full size either, and makes one PyTorch op per rounding.

Launch counter: ``launches`` counts the kernel launches of each
instantiation, keyed by ``instantiation(clouds, emit_d2, emit_recon,
emit_pts)``, so that the counts of all keys add up to the launches made.

Bound on the H100: fp32 operations, 48 per (line, neighbourhood) pair
(``OPS_PER_PAIR``) plus 33 per stored slot in recon mode
(``OPS_PER_RECON_SLOT``), none of them fused multiply-adds. ``chip_smoke.py``
reports the bound beside the measured time.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch._device import sqrt_rn
from a_robust_registration_loss_tpu_torch.ops.cuda import _build

KMAX = 4
NNEI = 3                # the kernel's neighbourhood size (the reference's only one)
OPS_PER_PAIR = 48       # 3 neighbours x 16 fp32 operations, counted in the .cu
OPS_PER_RECON_SLOT = 33  # 3 x (add, max, sqrt), 2 add, 1 div, 3 mul, 9 x (mul, add)
LINE_CHUNK = 1024       # lines per step of the plain version
EMPTY = 2**30           # slot_idx of an empty slot in the intersect_stage1* API
SEGMENTS = 4            # face segments the kernel splits a cloud into
STEP_FACES = 256        # faces of all segments the kernel sweeps between two barriers

launches = _build.launch_counter("stage1")


def instantiation(clouds: int, emit_d2: bool, emit_recon: bool, emit_pts: bool):
    """The key of ``launches`` for stage1_kernel<clouds, d2, recon, pts>."""
    return (clouds, bool(emit_d2), bool(emit_recon), bool(emit_pts))


def thresholds(delta):
    """Squared intersection thresholds, exactly as the TPU kernel's
    ``_pack_faces`` forms them."""
    return (delta * (1.731 / 2.0)) ** 2 - 2e-4


def _slot_d2(P, lines):
    """Gathered slot coordinates P (..., L, kmax, nnei, 3) -> the raw d2 of
    each neighbour against its line (..., L, kmax, nnei), in the kernel's
    order."""
    diff = [P[..., c] - lines[..., :, None, None, 3 + c] for c in range(3)]
    d_ac = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    proj = (diff[0] * lines[..., :, None, None, 0] + diff[1] * lines[..., :, None, None, 1]
            + diff[2] * lines[..., :, None, None, 2])
    return d_ac - proj * proj


def _slot_recon(P, d2):
    """The kernel's recon arithmetic on the stored slots: one reciprocal of
    sum d, nnei multiplies, the weighted sum started from 0."""
    nnei = P.shape[-2]
    d = [sqrt_rn(torch.clamp_min(d2[..., i] + 2e-4, 0.0)) for i in range(nnei)]
    dsum = d[0]
    for i in range(1, nnei):
        dsum = dsum + d[i]
    dinv = torch.reciprocal(dsum)
    rows = []
    for c in range(3):
        acc = 0.0 + (d[0] * dinv) * P[..., 0, c]
        for i in range(1, nnei):
            acc = acc + (d[i] * dinv) * P[..., i, c]
        rows.append(acc)
    return torch.stack(rows, dim=-1)


def _sweep_reference(neis, thr2, lines, kmax: int, line_chunk: int):
    """One sample, one cloud: neis (F, 3*nnei), thr2 (F,), lines (L, 6) ->
    (count (L,) int32, slot_idx (L, kmax) long with 0 on empty)."""
    F = neis.shape[0]
    nnei = neis.shape[1] // 3
    P = neis.reshape(F, nnei, 3)
    faces = torch.arange(F, device=neis.device)
    counts, slots = [], []
    for lo in range(0, lines.shape[0], line_chunk):
        ln = lines[lo:lo + line_chunk]
        n = ln.shape[0]
        label = torch.ones((n, F), dtype=torch.bool, device=neis.device)
        for i in range(nnei):
            diff = [P[None, :, i, c] - ln[:, 3 + c, None] for c in range(3)]
            d_ac = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
            proj = (diff[0] * ln[:, 0, None] + diff[1] * ln[:, 1, None]
                    + diff[2] * ln[:, 2, None])
            label &= d_ac - proj * proj < thr2[None, :]
        rank = torch.cumsum(label, dim=-1) - 1
        pos = torch.where(label & (rank < kmax), rank, kmax)
        # row kmax of each line is a dump for the hits past the first kmax
        buf = torch.zeros((n, kmax + 1), dtype=torch.long, device=neis.device)
        buf.scatter_(1, pos, faces.expand(n, F))
        counts.append(label.sum(-1, dtype=torch.int32))
        slots.append(buf[:, :kmax])
    return torch.cat(counts), torch.cat(slots)


def _payload_reference(neis, lines, count, slot_idx, kmax: int,
                       emit_d2: bool, emit_recon: bool, emit_pts: bool):
    """The sweep's (count, slot_idx) -> (count, slot_idx int32, d2, recon,
    pts or None each), formed from the stored faces."""
    nnei = neis.shape[1] // 3
    filled = (torch.arange(kmax, device=neis.device)[None, :]
              < torch.clamp_max(count, kmax)[:, None])
    pts = torch.where(filled[..., None], neis[slot_idx], 0.0).reshape(-1, kmax, nnei, 3)
    d2 = recon = None
    if emit_d2 or emit_recon:
        # the same elementwise ops on the stored faces give the sweep's bits
        d2 = torch.where(filled[..., None], _slot_d2(pts, lines), 0.0)
    if emit_recon:
        recon = torch.where(filled[..., None], _slot_recon(pts, d2), 0.0)
    return (count, slot_idx.int(), d2 if emit_d2 else None, recon,
            pts if emit_pts else None)


def segment_length(n_faces: int, segments: int) -> int:
    """Faces per segment when the kernel splits a cloud of n_faces into
    ``segments``: whole steps of STEP_FACES / segments faces."""
    step = STEP_FACES // segments
    return -(-(-(-n_faces // segments)) // step) * step


def _split_sweep_reference(neis, thr2, lines, kmax: int, line_chunk: int, segments: int):
    """The sweep as the kernel makes it with ``segments`` face segments:
    each segment swept on its own (its count, its first kmax hits), then
    merged per line in ascending segment order: slot k comes from the first
    segment whose running count passes k, and the count is the sum."""
    F, L = neis.shape[0], lines.shape[0]
    seg_len = segment_length(F, segments)
    slot = torch.arange(kmax, device=neis.device)[None, :]
    total = torch.zeros(L, dtype=torch.int32, device=neis.device)
    merged = torch.zeros((L, kmax), dtype=torch.long, device=neis.device)
    for s in range(segments):
        lo, hi = s * seg_len, min(F, (s + 1) * seg_len)
        if lo >= hi:
            break
        count, idx = _sweep_reference(neis[lo:hi], thr2[lo:hi], lines, kmax, line_chunk)
        k = slot - total[:, None]  # the slot's place in this segment's list
        here = (k >= 0) & (k < count[:, None])
        taken = torch.gather(idx, 1, k.clamp(0, kmax - 1)) + lo
        merged = torch.where(here, taken, merged)
        total = total + count
    return total, merged


def _stage1_reference(neis, thr2, lines, kmax: int, line_chunk: int,
                      emit_d2: bool, emit_recon: bool, emit_pts: bool, segments: int = 1):
    """One sample, one cloud: neis (F, 3*nnei), thr2 (F,), lines (L, 6) ->
    (count (L,), slot_idx (L, kmax) with 0 on empty, d2, recon, pts or None
    each)."""
    if segments == 1:
        count, slot_idx = _sweep_reference(neis, thr2, lines, kmax, line_chunk)
    else:
        count, slot_idx = _split_sweep_reference(neis, thr2, lines, kmax, line_chunk, segments)
    return _payload_reference(neis, lines, count, slot_idx, kmax, emit_d2, emit_recon, emit_pts)


def _check_inputs(neis, lines, deltas, kmax):
    dev = lines.device
    batched = lines.dim() == 3
    B = lines.shape[0] if batched else None
    for name, x in (("lines", lines), *(("neis", n) for n in neis),
                    *(("delta", d) for d in deltas)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"stage 1: {name} must be float32 on {dev}")
    if lines.dim() not in (2, 3) or lines.shape[-1] != 6:
        raise ValueError(f"stage 1: lines must be (L, 6) or (B, L, 6), got {tuple(lines.shape)}")
    for n, d in zip(neis, deltas):
        if n.dim() != lines.dim() or n.shape[-1] != 3 * NNEI:
            raise ValueError("stage 1: the kernel takes (F, 9) or (B, F, 9) "
                             f"neighbourhoods (nnei = 3) beside the lines, got {tuple(n.shape)}")
        if d.shape != n.shape[:-1]:
            raise ValueError(f"stage 1: delta {tuple(d.shape)} does not match "
                             f"neighbourhoods {tuple(n.shape)}")
        if batched and n.shape[0] != B:
            raise ValueError("stage 1: neighbourhoods and lines differ in batch size")
    if kmax < 1:
        raise ValueError("stage 1: kmax must be >= 1")


def stage1_reference(neis, lines, deltas, kmax: int = KMAX, emit_d2: bool = True,
                     emit_recon: bool = True, emit_pts: bool = False,
                     line_chunk: int = LINE_CHUNK, segments: int = 1):
    """Plain PyTorch version of ``stage1``, same outputs on any device.
    With ``segments`` > 1 it sweeps every cloud in that many face segments
    of ``segment_length`` faces and merges them per line by the kernel's
    rule: the outputs are exactly those of one segment."""
    if segments < 1:
        raise ValueError("stage 1: segments must be >= 1")
    batched = lines.dim() == 3
    if not batched:
        neis, deltas, lines = [n[None] for n in neis], [d[None] for d in deltas], lines[None]
    per_sample = []
    for b in range(lines.shape[0]):
        clouds = [_stage1_reference(n[b], thresholds(d[b]), lines[b], kmax, line_chunk,
                                    emit_d2, emit_recon, emit_pts, segments)
                  for n, d in zip(neis, deltas)]
        per_sample.append([None if outs[0] is None else torch.stack(outs)
                           for outs in zip(*clouds)])
    out = tuple(None if outs[0] is None else torch.stack(outs)
                for outs in zip(*per_sample))
    return out if batched else tuple(None if x is None else x[0] for x in out)


def stage1(neis, lines, deltas, kmax: int = KMAX, emit_d2: bool = True,
           emit_recon: bool = True, emit_pts: bool = False):
    """Stage 1 of one or two clouds against one line set, raw layout.

    neis: a sequence of 1 or 2 neighbourhood tensors (F_c, 9) or
    (B, F_c, 9); lines (L, 6) or (B, L, 6); deltas the matching adaptive
    thresholds (F_c,) or (B, F_c) (``neighborhood_delta``). Returns (count
    (..., C, L) int32, slot_idx (..., C, L, kmax) int32 with 0 on empty
    slots, slot_d2 (..., C, L, kmax, nnei), slot_recon (..., C, L, kmax, 3),
    slot_pts (..., C, L, kmax, nnei, 3)), each mode's output None when it is
    off; C is the number of clouds.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    once (or raises)."""
    neis, deltas = tuple(neis), tuple(deltas)
    if len(neis) not in (1, 2) or len(deltas) != len(neis):
        raise ValueError("stage 1: one or two clouds, each with its deltas")
    if lines.device.type == "cpu":
        return stage1_reference(neis, lines, deltas, kmax, emit_d2, emit_recon, emit_pts)
    if lines.device.type != "cuda":
        raise ValueError(f"stage 1: unsupported device {lines.device}")
    _check_inputs(neis, lines, deltas, kmax)
    dev = lines.device
    batch = lines.shape[:-2]
    B = lines.shape[0] if batch else 1
    L, C = lines.shape[-2], len(neis)
    lines = lines.detach().contiguous()
    neis = [n.detach().contiguous() for n in neis]
    thr = [thresholds(d.detach()).contiguous() for d in deltas]
    F = [n.shape[-2] for n in neis]
    rows = batch + (C, L)
    count = torch.empty(rows, dtype=torch.int32, device=dev)
    slot_idx = torch.empty(rows + (kmax,), dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    slot_d2 = torch.empty(rows + (kmax, NNEI), **f32) if emit_d2 else None
    slot_recon = torch.empty(rows + (kmax, 3), **f32) if emit_recon else None
    slot_pts = torch.empty(rows + (kmax, NNEI, 3), **f32) if emit_pts else None
    out = (count, slot_idx, slot_d2, slot_recon, slot_pts)
    if L == 0 or B == 0:
        return out
    second = 1 if C == 2 else 0
    mode = int(emit_d2) | int(emit_recon) << 1 | int(emit_pts) << 2
    rc = _build.library().arrl_stage1(
        C, mode, lines.data_ptr(), B, L, neis[0].data_ptr(), thr[0].data_ptr(),
        F[0], neis[second].data_ptr(), thr[second].data_ptr(), F[second], kmax,
        count.data_ptr(), slot_idx.data_ptr(),
        *(None if x is None else x.data_ptr() for x in (slot_d2, slot_recon, slot_pts)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "arrl_stage1")
    launches[instantiation(C, emit_d2, emit_recon, emit_pts)] += 1
    return out


CLOUD_AXIS = (-2, -3, -4, -4, -5)  # of count, slot_idx, d2, recon, pts in stage1's layout


def _unpack(out, cloud: int, kmax: int):
    """Raw outputs -> one cloud's (count, slot_idx with EMPTY on empty
    slots, slot_d2, slot_recon, slot_pts), as the JAX ``_unpack``."""
    count, slot_idx, *modes = (None if x is None else x.select(axis, cloud)
                               for axis, x in zip(CLOUD_AXIS, out))
    filled = (torch.arange(kmax, device=count.device)
              < torch.clamp_max(count, kmax)[..., None])
    return (count, torch.where(filled, slot_idx, EMPTY), *modes)


def intersect_stage1(point_neis, lines, delta, kmax: int = KMAX,
                     emit_d2: bool = True, emit_recon: bool = True,
                     emit_pts: bool = False):
    """Stage 1 of one cloud, the JAX ``intersect_stage1``: point_neis
    (..., F, 9), lines (..., L, 6), delta (..., F). Returns (count (..., L),
    slot_idx (..., L, kmax) with 2**30 on empty slots, slot_d2 (..., L,
    kmax, nnei) without the +2e-4, slot_recon (..., L, kmax, 3), slot_pts
    (..., L, kmax, nnei, 3)), None for each mode that is off."""
    return _unpack(stage1((point_neis,), lines, (delta,), kmax, emit_d2,
                          emit_recon, emit_pts), 0, kmax)


def intersect_stage1_pair(point_neis1, point_neis2, lines, delta1, delta2,
                          kmax: int = KMAX, emit_d2: bool = True,
                          emit_recon: bool = True, emit_pts: bool = False):
    """Both clouds of a pair in one launch, the JAX
    ``intersect_stage1_pair``: two ``intersect_stage1`` tuples."""
    out = stage1((point_neis1, point_neis2), lines, (delta1, delta2), kmax,
                 emit_d2, emit_recon, emit_pts)
    return _unpack(out, 0, kmax), _unpack(out, 1, kmax)
