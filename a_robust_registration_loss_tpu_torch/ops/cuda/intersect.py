"""Paired stage-1 sweep of the robust metric in pts mode: the kernel
``csrc/intersect.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``a_robust_registration_loss_tpu/ops/pallas/
intersect.py:_kernel`` with ``emit_pts=True``, as launched by ``_pair_call``
through ``intersect_stage1_pair_lanemajor``. For both clouds of a pair and
one line set it tests every (line, neighbourhood) pair:

    d2_i = |p_i - x0|^2 - ((p_i - x0) . dir)^2   (per component, in order)
    hit  = all_i d2_i < thr2,  thr2 = (delta * 1.731/2)^2 - 2e-4

and returns the uncapped hit count per line plus the first kmax hit faces
in ascending face order, as indices and as their gathered neighbour
coordinates. Empty slots hold 0. No gradient flows through stage 1.

The public layout is (cloud, L, kmax, ...) rather than the TPU's lane-major
one. Kernel and plain version agree exactly (counts, slots, coordinates);
the plain version walks the lines in chunks so that it never holds an
O(L*F) tensor at full size either.

Bound on the H100: fp32 operations, 48 per (line, neighbourhood) pair
(``OPS_PER_PAIR``): 0.059 ms at F = 2,048 per cloud and L = 20,000 at the
data sheet's 67 TFLOP/s. ``chip_smoke.py`` reports it beside the measured
time.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch.ops.cuda import _build

KMAX = 4
NNEI = 3            # the kernel's neighbourhood size (the reference's only one)
OPS_PER_PAIR = 48   # 3 neighbours x 16 fp32 operations, counted in the .cu
LINE_CHUNK = 1024   # lines per step of the plain version

launches = 0  # kernel launches since the last reset (plain runs not counted)


def thresholds(delta):
    """Squared intersection thresholds, exactly as the TPU kernel's
    ``_pack_faces`` forms them."""
    return (delta * (1.731 / 2.0)) ** 2 - 2e-4


def _stage1_reference(neis, thr2, lines, kmax: int, line_chunk: int):
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
    count = torch.cat(counts)
    slot_idx = torch.cat(slots)
    filled = (torch.arange(kmax, device=neis.device)[None, :]
              < torch.clamp_max(count, kmax)[:, None])
    pts = torch.where(filled[..., None], neis[slot_idx], 0.0)
    return count, slot_idx.int(), pts.reshape(-1, kmax, nnei, 3)


def intersect_stage1_pair_pts_reference(neis1, neis2, lines, delta1, delta2,
                                        kmax: int = KMAX,
                                        line_chunk: int = LINE_CHUNK):
    """Plain PyTorch version of the kernel, same outputs."""
    outs = [_stage1_reference(n, thresholds(d), lines, kmax, line_chunk)
            for n, d in ((neis1, delta1), (neis2, delta2))]
    return tuple(torch.stack([a, b]) for a, b in zip(*outs))


def intersect_stage1_pair_pts(neis1, neis2, lines, delta1, delta2,
                              kmax: int = KMAX):
    """Stage 1 of both clouds against one line set.

    neis1 (F1, 9), neis2 (F2, 9) neighbourhoods; lines (L, 6) [dir | x0];
    delta1/delta2 (F1,)/(F2,) adaptive thresholds (``neighborhood_delta``).
    Returns count (2, L) int32, slot_idx (2, L, kmax) int32 and slot_pts
    (2, L, kmax, nnei, 3) float32; empty slots hold 0.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    global launches
    if lines.device.type == "cpu":
        return intersect_stage1_pair_pts_reference(neis1, neis2, lines,
                                                   delta1, delta2, kmax)
    if lines.device.type != "cuda":
        raise ValueError(f"intersect_stage1_pair_pts: unsupported device {lines.device}")
    dev = lines.device
    for name, x in (("neis1", neis1), ("neis2", neis2), ("lines", lines),
                    ("delta1", delta1), ("delta2", delta2)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"intersect_stage1_pair_pts: {name} must be float32 on {dev}")
    if neis1.dim() != 2 or neis1.shape[1] != 3 * NNEI or neis2.dim() != 2 \
            or neis2.shape[1] != 3 * NNEI:
        raise ValueError("intersect_stage1_pair_pts: the kernel takes (F, 9) "
                         "neighbourhoods (nnei = 3)")
    if lines.dim() != 2 or lines.shape[1] != 6:
        raise ValueError(f"intersect_stage1_pair_pts: lines must be (L, 6), got {tuple(lines.shape)}")
    if kmax < 1:
        raise ValueError("intersect_stage1_pair_pts: kmax must be >= 1")
    L = lines.shape[0]
    F1, F2 = neis1.shape[0], neis2.shape[0]
    neis1, neis2, lines = (x.detach().contiguous() for x in (neis1, neis2, lines))
    thr1 = thresholds(delta1.detach()).contiguous()
    thr2 = thresholds(delta2.detach()).contiguous()
    count = torch.empty((2, L), dtype=torch.int32, device=dev)
    slot_idx = torch.empty((2, L, kmax), dtype=torch.int32, device=dev)
    slot_pts = torch.empty((2, L, kmax, NNEI, 3), dtype=torch.float32, device=dev)
    if L == 0:
        return count, slot_idx, slot_pts
    lib = _build.library()
    rc = lib.arrl_stage1_pair(
        lines.data_ptr(), L, neis1.data_ptr(), thr1.data_ptr(), F1,
        neis2.data_ptr(), thr2.data_ptr(), F2, kmax, count.data_ptr(),
        slot_idx.data_ptr(), slot_pts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "arrl_stage1_pair")
    launches += 1
    return count, slot_idx, slot_pts
