"""The intersected-line robust registration metric.

Port of ``a_robust_registration_loss_tpu/ops/metric.py`` on its Pallas
backend: stage 1 (``find_intersections``, the (count, slot) record of the
first kmax neighbourhoods each line intersects), the slot reconstruction
with detached weights, then stage 2 (exact masked lower median, Welsch,
per-(k, j)-combo normalisation, exp(-0.5|k-j|) weights, division by the
number of nonempty combos). Entry points: ``intersection_loss`` and its
batch ``intersection_loss_batch``, ``intersection_loss_transformed`` (cloud 1
through a differentiable map) and ``intersection_loss_rigid`` (cloud 1
through p @ R + t, optionally batched).

Stage 1 is ``ops/cuda/intersect.py``: the kernel on a CUDA tensor, its
plain version on a CPU tensor; one launch per call, batch included. It
carries no gradient. Every function takes an optional leading batch axis
where its docstring says so; a batch keeps one median, one nonempty-combo
count and one ``valid`` per sample, exactly like B separate calls. Sums keep
the JAX arithmetic order (left to right from the first term), so values
match to the last bits the hardware allows.

Gradients, as in the reference's autograd graph: through the slot
reconstruction only. ``intersection_loss`` takes the value from the
kernel's gathered coordinates and routes the gradient through
``slot_points_kernel``, an ``index_add_`` of w/nnei into the selected rows;
the transformed and rigid paths differentiate the map applied to the
gathered raw points instead. On the card the rigid path's stage 2 and its
gradient are the kernels of ``ops/cuda/rigid_loss.py``, whose backward is
written out; the line-parallel path (``train/losses.py``) keeps
``rigid_slots`` and ``stage2``.

Faithful quirks kept from the JAX package: ``welsch(x, c) = 1 -
exp(-(x/c)/2)`` on squared distances; the +2e-4 inside the point-line
distance; the reconstruction is the 1/nnei-scaled weighted mean; a masked
median of exactly 0 makes the loss NaN while ``valid`` stays True.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from a_robust_registration_loss_tpu_torch._device import sqrt_rn
from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK

NNEI_DEFAULT = IK.NNEI  # points a neighbourhood, the reference's only size


class Intersections(NamedTuple):
    """Fixed-shape per-line intersection record (stage-1 output).

    count:    (..., L) int32, the number of intersected neighbourhoods
              (uncapped).
    slot_idx: (..., L, kmax) int32, the first kmax intersected
              neighbourhoods in ascending order; F where the slot is empty.
    slot_w:   (..., L, kmax, nnei), the detached weights d_i / sum(d) of each
              filled slot; 0 where empty.
    """

    count: torch.Tensor
    slot_idx: torch.Tensor
    slot_w: torch.Tensor


def welsch(x, c):
    """1 - exp(-(x/c)/2): x is a squared distance, x/c is not squared."""
    return 1.0 - torch.exp(-(x / c) / 2.0)


def _norm3(v):
    return sqrt_rn(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])


def _bc(x):
    """A per-sample scalar (B,) against (B, L, kmax) slot tensors; a 0-d
    scalar is left as it is."""
    return x if x.dim() == 0 else x[..., None, None]


def neighborhood_delta(point_neis):
    """Locally adaptive threshold: mean pairwise spacing of each
    neighbourhood, (..., F, nnei*3) -> (..., F). At nnei = 3 the exact
    3-term order (d01 + d02 + d12) / 3."""
    nnei = point_neis.shape[-1] // 3
    if nnei == 3:
        p0, p1, p2 = point_neis[..., 0:3], point_neis[..., 3:6], point_neis[..., 6:9]
        return (_norm3(p1 - p0) + _norm3(p2 - p0) + _norm3(p1 - p2)) / 3.0
    P = point_neis.reshape(point_neis.shape[:-1] + (nnei, 3))
    d = _norm3(P[..., :, None, :] - P[..., None, :, :])
    iu, ju = torch.triu_indices(nnei, nnei, 1, device=point_neis.device)
    return d[..., iu, ju].mean(-1)


def _slot_mask(count, kmax: int):
    """(..., L, kmax) True where the slot holds a face: s < min(count, kmax)."""
    ar = torch.arange(kmax, device=count.device)
    return ar < torch.clamp_max(count, kmax)[..., None]


def _slot_dists(P, lines):
    """Gathered slot coordinates P (..., L, kmax, nnei, 3) -> the point-line
    distances sqrt(max(d2 + 2e-4, 0)) of each neighbour, a list of nnei
    (..., L, kmax) tensors, recomputed against the lines in the JAX
    ``recon_rows`` order."""
    dirs = [lines[..., :, None, c] for c in range(3)]
    x0 = [lines[..., :, None, 3 + c] for c in range(3)]
    d = []
    for i in range(P.shape[-2]):
        diff = [P[..., i, c] - x0[c] for c in range(3)]
        d_ac = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        proj = diff[0] * dirs[0] + diff[1] * dirs[1] + diff[2] * dirs[2]
        d.append(sqrt_rn(torch.clamp_min(d_ac - proj * proj + 2e-4, 0.0)))
    return d


def _weights(d):
    """Distances (a list of nnei tensors) -> the weights d_i / sum_j d_j."""
    dsum = d[0]
    for i in range(1, len(d)):
        dsum = dsum + d[i]
    return [d[i] / dsum for i in range(len(d))]


def _recon(P, count, lines, kmax: int):
    """Gathered slot coordinates P (..., L, kmax, nnei, 3) -> the weighted
    reconstruction sum_i w_i p_i (..., L, kmax, 3), 0 on empty slots."""
    w = _weights(_slot_dists(P, lines))
    filled = _slot_mask(count, kmax)
    rows = []
    for c in range(3):
        acc = w[0] * P[..., 0, c]
        for i in range(1, len(w)):
            acc = acc + w[i] * P[..., i, c]
        rows.append(torch.where(filled, acc, 0.0))
    return torch.stack(rows, dim=-1)


def _outputs_to_inter(point_neis, outputs, lines=None):
    """One cloud's stage-1 outputs (count, slot_idx, slot_d2 | None, _,
    slot_pts | None), from d2 mode or from pts mode with ``lines`` ->
    (Intersections, recon | None).

    The weights come from the kernel's raw d2 when emitted, else they are
    recomputed from the exact gathered coordinates; in pts mode the
    reconstruction sum_i w_i p_i is formed here on the kmax slots."""
    count, slot_idx, slot_d2, _, slot_pts = outputs
    F = point_neis.shape[-2]
    nnei = point_neis.shape[-1] // 3
    filled = slot_idx < F
    slot_idx = torch.where(filled, slot_idx, F).int()
    if slot_d2 is not None:
        d = [sqrt_rn(torch.clamp_min(slot_d2[..., i] + 2e-4, 0.0)) for i in range(nnei)]
    else:
        d = _slot_dists(slot_pts, lines.detach())
    w = torch.where(filled[..., None], torch.stack(_weights(d), dim=-1), 0.0)
    recon = None
    if slot_pts is not None:
        recon = w[..., 0, None] * slot_pts[..., 0, :]
        for i in range(1, nnei):
            recon = recon + w[..., i, None] * slot_pts[..., i, :]
    return Intersections(count, slot_idx, w), recon


def find_intersections(point_neis, lines, kmax: int = 4) -> Intersections:
    """Stage 1 of the metric (reference: loss.py:68-112): point_neis
    (..., F, nnei*3), lines (..., L, 6), an optional leading batch axis on
    both. One launch of the kernel in d2 mode on a CUDA tensor, its plain
    version on a CPU tensor. Labels take the kernel's form d2 < thr2."""
    with torch.no_grad():
        point_neis, lines = point_neis.detach(), lines.detach()
        out = IK.intersect_stage1(point_neis, lines, neighborhood_delta(point_neis),
                                  kmax, emit_d2=True, emit_recon=False,
                                  emit_pts=False)
        return _outputs_to_inter(point_neis, out)[0]


def _take_rows(P, idx):
    """P (..., F, nnei, 3), idx (..., L, kmax) -> P's rows (..., L, kmax,
    nnei, 3), per sample when batched."""
    if P.dim() == 3:
        return P[idx]
    b = torch.arange(P.shape[0], device=P.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return P[b, idx]


def _reconstruct(P, inter: Intersections, apply_fn=None):
    """P (..., F, nnei, 3) -> the masked mean over nnei of w_i * p_i of
    each slot's rows, through ``apply_fn`` when one is given."""
    F = P.shape[-3]
    P_sel = _take_rows(P, torch.clamp_max(inter.slot_idx, F - 1))
    if apply_fn is not None:
        P_sel = apply_fn(P_sel)
    pts = (inter.slot_w.detach()[..., None] * P_sel).mean(dim=-2)
    return torch.where((inter.slot_idx < F)[..., None], pts, 0.0)


def reconstruct_intersection_points(point_neis, inter: Intersections):
    """Differentiable slot points (..., L, kmax, 3): the mean over nnei of
    w_i * p_i, the reference's 1/3-scaled weighted combination
    (loss.py:155-163). Gradients flow into point_neis (..., F, nnei*3);
    empty slots give zeros."""
    return _reconstruct(point_neis.reshape(point_neis.shape[:-1] + (-1, 3)), inter)


def reconstruct_intersection_points_via(point_neis, inter: Intersections,
                                        apply_fn):
    """Gather the RAW neighbours into slots, then apply the differentiable
    pointwise map ``apply_fn`` ((..., 3) -> (..., 3), e.g. p @ R + t) to the
    gathered points: the same value as transforming the whole array first,
    with a backward that reduces over the slots into the map's parameters."""
    return _reconstruct(point_neis.detach().reshape(point_neis.shape[:-1] + (-1, 3)),
                        inter, apply_fn)


def slot_points_kernel_bwd(point_neis_shape, slot_idx, slot_w, cot):
    """The gradient of ``slot_points_kernel`` with respect to point_neis:
    where(filled, w_i * cot, 0) / nnei added into the selected rows
    (``index_add_``; atomic on the card, so not bitwise reproducible
    there)."""
    F = point_neis_shape[-2]
    nnei = point_neis_shape[-1] // 3
    filled = slot_idx < F
    contrib = torch.where(filled[..., None, None],
                          slot_w[..., None] * cot[..., None, :], 0.0) / nnei
    idx = torch.clamp_max(slot_idx, F - 1).long()
    if len(point_neis_shape) == 3:  # rows of sample b start at b * F
        B = point_neis_shape[0]
        idx = idx + F * torch.arange(B, device=idx.device).reshape((B,) + (1,) * (idx.dim() - 1))
    rows = torch.Size(point_neis_shape[:-1]).numel()
    gP = torch.zeros((rows, nnei, 3), dtype=cot.dtype, device=cot.device)
    gP.index_add_(0, idx.reshape(-1), contrib.reshape(-1, nnei, 3))
    return gP.reshape(point_neis_shape)


class _SlotPointsKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, point_neis, kernel_pts, slot_idx, slot_w):
        ctx.save_for_backward(slot_idx, slot_w)
        ctx.point_neis_shape = point_neis.shape
        return kernel_pts.clone()

    @staticmethod
    def backward(ctx, cot):
        slot_idx, slot_w = ctx.saved_tensors
        return (slot_points_kernel_bwd(ctx.point_neis_shape, slot_idx, slot_w, cot),
                None, None, None)


def slot_points_kernel(point_neis, kernel_pts, slot_idx, slot_w):
    """Slot points whose VALUE is the kernel-gathered reconstruction
    kernel_pts (..., L, kmax, 3) (the masked sum_i w_i p_i / nnei) and whose
    GRADIENT with respect to point_neis is the gather path's
    (``reconstruct_intersection_points``): no forward row gather. No
    gradient reaches kernel_pts, slot_idx or slot_w."""
    return _SlotPointsKernel.apply(point_neis, kernel_pts.detach(), slot_idx,
                                   slot_w.detach())


def _masked_lower_median(values, mask, batch_dims: int = 0):
    """torch.median semantics on a masked set: the (n-1)//2-th order
    statistic of the valid entries, per sample over everything after the
    first ``batch_dims`` axes, read with a device-side gather (no host
    sync)."""
    shape = values.shape[:batch_dims] + (-1,)
    flat = torch.where(mask, values, torch.inf).reshape(shape)
    srt = torch.sort(flat, dim=-1).values
    k = torch.clamp_min((mask.reshape(shape).sum(-1) - 1) // 2, 0)
    return srt.gather(-1, k[..., None])[..., 0]


def stage2(pts1, pts2, c1, c2, kmin: int, kmax: int):
    """The robust loss from slot points (..., L, kmax, 3) and per-line
    counts (..., L). Returns (loss, valid), one per sample; valid is False
    when no line is usable (the reference's no-intersection sentinel)."""
    lvalid = (c1 >= kmin) & (c1 <= kmax) & (c2 >= kmin) & (c2 <= kmax)
    slot_ok1 = _slot_mask(c1, kmax) & lvalid[..., None]
    slot_ok2 = _slot_mask(c2, kmax) & lvalid[..., None]
    diff = [pts1[..., :, :, None, c] - pts2[..., :, None, :, c] for c in range(3)]
    D = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]  # (..., L, K, K)
    pair_ok = slot_ok1[..., :, :, None] & slot_ok2[..., :, None, :]
    median = _bc(_masked_lower_median(D.detach(), pair_ok, D.dim() - 3))

    rowmin = torch.where(slot_ok2[..., :, None, :], D, torch.inf).amin(dim=-1)
    colmin = torch.where(slot_ok1[..., :, :, None], D, torch.inf).amin(dim=-2)

    # lines per (k, j) combo; invalid lines go to the extra last bucket
    nC = kmax - kmin + 1
    cid = torch.where(lvalid, (c1 - kmin) * nC + (c2 - kmin), nC * nC).long()
    n_combo = torch.zeros(cid.shape[:-1] + (nC * nC + 1,), dtype=torch.int32,
                          device=c1.device)
    n_combo.scatter_add_(-1, cid, torch.ones_like(cid, dtype=torch.int32))
    n_nonempty = (n_combo[..., :nC * nC] > 0).sum(-1)
    n_line = torch.where(lvalid, n_combo.gather(-1, cid), 1)

    row_w = torch.where(slot_ok1, welsch(rowmin, median), 0.0)
    col_w = torch.where(slot_ok2, welsch(colmin, median), 0.0)
    row_sum, col_sum = row_w[..., 0], col_w[..., 0]
    for s in range(1, kmax):
        row_sum = row_sum + row_w[..., s]
        col_sum = col_sum + col_w[..., s]
    row_term = row_sum / (n_line * torch.clamp_min(c1, 1).float())
    col_term = col_sum / (n_line * torch.clamp_min(c2, 1).float())
    w_line = torch.exp(-0.5 * (c1 - c2).abs().float())
    per_line = torch.where(lvalid, w_line * (row_term + col_term), 0.0)
    loss = per_line.sum(-1) / torch.clamp_min(n_nonempty, 1).float()
    return loss, n_nonempty > 0


def intersection_loss_from_slots(pts1, inter1: Intersections, pts2,
                                 inter2: Intersections, kmin: int = 1,
                                 kmax: int = 4):
    """Stage 2 from two intersection records and their slot points
    (reference: loss.py:115-232). Returns (loss, valid) per sample."""
    return stage2(pts1, pts2, inter1.count, inter2.count, kmin, kmax)


def _pair_pts(point_neis1, point_neis2, lines, kmax: int):
    """Both clouds' stage 1 in one pts-mode launch -> two (Intersections,
    recon) with the weights recomputed from the gathered coordinates."""
    with torch.no_grad():
        n1, n2, lines = point_neis1.detach(), point_neis2.detach(), lines.detach()
        out1, out2 = IK.intersect_stage1_pair(
            n1, n2, lines, neighborhood_delta(n1), neighborhood_delta(n2), kmax,
            emit_d2=False, emit_recon=False, emit_pts=True)
        return _outputs_to_inter(n1, out1, lines), _outputs_to_inter(n2, out2, lines)


def intersection_loss(point_neis1, point_neis2, lines, kmin: int = 1,
                      kmax: int = 4):
    """The whole metric (reference:
    cal_loss_intersection_batch_whole_median_pts_lines, loss.py:170-232,
    with (s_m, s_n, e_m, e_n) == (kmin, kmin, kmax+1, kmax+1)).

    point_neis1 (..., F1, nnei*3), point_neis2 (..., F2, nnei*3), lines
    (..., L, 6). Returns (loss, valid), per sample when batched. The value
    comes from the kernel's exact gathered coordinates; the gradient reaches
    both clouds through ``slot_points_kernel``."""
    (inter1, recon1), (inter2, recon2) = _pair_pts(point_neis1, point_neis2,
                                                   lines, kmax)
    nnei = point_neis1.shape[-1] // 3
    pts1 = slot_points_kernel(point_neis1, recon1 / nnei, inter1.slot_idx,
                              inter1.slot_w)
    pts2 = slot_points_kernel(point_neis2, recon2 / nnei, inter2.slot_idx,
                              inter2.slot_w)
    return stage2(pts1, pts2, inter1.count, inter2.count, kmin, kmax)


def intersection_loss_batch(point_neis1, point_neis2, lines, kmin: int = 1,
                            kmax: int = 4):
    """Batched metric: (B, F1, 9) x (B, F2, 9) x (B, L, 6) -> ((B,), (B,)),
    one stage-1 launch for all samples; per-sample medians and
    normalisations, exactly like B separate calls."""
    if lines.dim() != 3:
        raise ValueError(f"intersection_loss_batch: lines must be (B, L, 6), got {tuple(lines.shape)}")
    return intersection_loss(point_neis1, point_neis2, lines, kmin, kmax)


def intersection_loss_transformed(apply_fn, point_neis1, point_neis2, lines,
                                  kmin: int = 1, kmax: int = 4):
    """The whole metric where cloud 1 is ``apply_fn(point_neis1)``, the
    registration-training pattern, for one sample: point_neis1/2 (F, 9),
    lines (L, 6), apply_fn a pointwise map (..., 3) -> (..., 3). Same value
    and gradient as ``intersection_loss(apply_fn(point_neis1), ...)``, with
    cloud 1's gradient through apply_fn on the gathered raw points."""
    with torch.no_grad():
        neis1_t = apply_fn(point_neis1.detach().reshape(-1, 3)).reshape(point_neis1.shape)
    (inter1, _), (inter2, recon2) = _pair_pts(neis1_t, point_neis2, lines, kmax)
    nnei = point_neis2.shape[-1] // 3
    pts2 = slot_points_kernel(point_neis2, recon2 / nnei, inter2.slot_idx,
                              inter2.slot_w)
    pts1 = reconstruct_intersection_points_via(point_neis1, inter1, apply_fn)
    return stage2(pts1, pts2, inter1.count, inter2.count, kmin, kmax)


def _rigid_stage1(R, t, point_neis1, point_neis2, lines, kmax: int):
    """Stage 1 of the rigid path, without a gradient: cloud 1 moved by the
    detached (R, t), both clouds in one pts-mode launch -> (count (..., 2,
    L) int32, slot points (..., 2, L, kmax, nnei, 3))."""
    with torch.no_grad():
        lines = lines.detach()
        if R.dim() == 2:
            neis1_t = (point_neis1.reshape(-1, 3) @ R + t).reshape(point_neis1.shape)
        else:
            B = R.shape[0]
            neis1_t = (point_neis1.reshape(B, -1, 3) @ R
                       + t[:, None, :]).reshape(point_neis1.shape)
        neis2 = point_neis2.detach()
        count, _idx, _, _, pts = IK.stage1(
            (neis1_t, neis2), lines, (neighborhood_delta(neis1_t), neighborhood_delta(neis2)),
            kmax, emit_d2=False, emit_recon=False, emit_pts=True)
    return count, pts


def _rigid_tail(R, t, count, pts, lines, kmax: int):
    """``rigid_slots`` after stage 1, from its records (count (..., 2, L),
    slot points (..., 2, L, kmax, nnei, 3)) -> (pts1, pts2, c1, c2, raw),
    raw cloud 1's reconstructions moved back by the detached (R, t), a list
    of 3 (..., L, kmax) tensors (no gradient)."""
    nnei = pts.shape[-2]
    with torch.no_grad():
        lines = lines.detach()
        c1, c2 = count[..., 0, :], count[..., 1, :]
        r1 = _recon(pts[..., 0, :, :, :, :], c1, lines, kmax)
        r2 = _recon(pts[..., 1, :, :, :, :], c2, lines, kmax)
        Rd, td = R.detach(), t.detach()
        u = [r1[..., k] - _bc(td[..., k]) for k in range(3)]
        raw = [u[0] * _bc(Rd[..., c, 0]) + u[1] * _bc(Rd[..., c, 1])
               + u[2] * _bc(Rd[..., c, 2]) for c in range(3)]   # (v - t) @ R^T
    filled1 = _slot_mask(c1, kmax)
    fwd = [raw[0] * _bc(R[..., 0, c]) + raw[1] * _bc(R[..., 1, c])
           + raw[2] * _bc(R[..., 2, c]) + _bc(t[..., c]) for c in range(3)]  # raw @ R + t
    pts1 = torch.stack([torch.where(filled1, f / nnei, 0.0) for f in fwd],
                       dim=-1)
    pts2 = torch.where(_slot_mask(c2, kmax)[..., None], r2 / nnei, 0.0)
    return pts1, pts2, c1, c2, raw


def rigid_slots(R, t, point_neis1, point_neis2, lines, kmax: int):
    """Stage 1 and slot reconstruction of the rigid path ->
    (pts1 (..., L, kmax, 3), pts2 (..., L, kmax, 3), c1 (..., L), c2 (..., L)).
    R (..., 3, 3) and t (..., 3) with the same optional batch axis as the
    clouds and lines.

    Stage 1 sees the already-transformed cloud 1 (detached), so its
    reconstruction is un-transformed with the detached (R, t) and
    re-transformed with the traced ones: the only place gradients enter."""
    count, pts = _rigid_stage1(R, t, point_neis1, point_neis2, lines, kmax)
    return _rigid_tail(R, t, count, pts, lines, kmax)[:4]


def intersection_loss_rigid(R, t, point_neis1, point_neis2, lines,
                            kmin: int = 1, kmax: int = 4):
    """The metric with cloud 1 rigidly transformed, p' = p @ R + t (row
    convention). R (..., 3, 3), t (..., 3), point_neis1/2 (..., F, nnei*3),
    lines (..., L, 6), with one optional leading batch axis on all five.
    Returns (loss, valid) as device tensors, per sample when batched, with
    one stage-1 launch; the gradient flows to R and t.

    On the card, stage 1's outputs go to ``ops/cuda/rigid_loss.py``
    (``rigid_metric``): the rest of the metric in three launches, its
    gradient in two, autograd's bit for bit. On the CPU, ``rigid_slots``
    and ``stage2`` with autograd."""
    if lines.device.type == "cuda":
        # imported here: ops/cuda/rigid_loss.py imports this module for its plain version
        from a_robust_registration_loss_tpu_torch.ops.cuda import rigid_loss as RL

        count, pts = _rigid_stage1(R, t, point_neis1, point_neis2, lines, kmax)
        return RL.rigid_metric(R, t, count, pts, lines, kmin, kmax)
    pts1, pts2, c1, c2 = rigid_slots(R, t, point_neis1, point_neis2, lines,
                                     kmax)
    return stage2(pts1, pts2, c1, c2, kmin, kmax)
