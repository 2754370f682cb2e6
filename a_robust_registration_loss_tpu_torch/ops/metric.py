"""The intersected-line robust registration metric, rigid path.

Port of the rigid path of ``a_robust_registration_loss_tpu/ops/metric.py``
(``intersection_loss_rigid`` on the Pallas backend): paired stage 1, slot
reconstruction with detached weights, then stage 2 (exact masked lower
median, Welsch, per-(k, j)-combo normalisation, exp(-0.5|k-j|) weights,
division by the number of nonempty combos).

Stage 1 is ``ops/cuda/intersect.py``: the kernel on a CUDA tensor, its
plain version on a CPU tensor. It carries no gradient. The layout is the
public (L, kmax, ...) one, but every sum keeps the JAX arithmetic order
(left to right from the first term), so values match to the last bits the
hardware allows. The only gradient path is the re-transform of the slot
reconstruction with the traced (R, t), as in the reference's autograd graph.

Faithful quirks kept from the JAX package: ``welsch(x, c) = 1 -
exp(-(x/c)/2)`` on squared distances; the +2e-4 inside the point-line
distance; the reconstruction is the 1/nnei-scaled weighted mean; a masked
median of exactly 0 makes the loss NaN while ``valid`` stays True.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch._device import sqrt_rn
from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK


def welsch(x, c):
    """1 - exp(-(x/c)/2): x is a squared distance, x/c is not squared."""
    return 1.0 - torch.exp(-(x / c) / 2.0)


def _norm3(v):
    return sqrt_rn(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])


def neighborhood_delta(point_neis):
    """Locally adaptive threshold: mean pairwise spacing of each
    neighbourhood, (F, nnei*3) -> (F,). At nnei = 3 the exact 3-term order
    (d01 + d02 + d12) / 3."""
    nnei = point_neis.shape[1] // 3
    if nnei == 3:
        p0, p1, p2 = point_neis[:, 0:3], point_neis[:, 3:6], point_neis[:, 6:9]
        return (_norm3(p1 - p0) + _norm3(p2 - p0) + _norm3(p1 - p2)) / 3.0
    P = point_neis.reshape(point_neis.shape[0], nnei, 3)
    d = _norm3(P[:, :, None, :] - P[:, None, :, :])
    iu, ju = torch.triu_indices(nnei, nnei, 1, device=point_neis.device)
    return d[:, iu, ju].mean(-1)


def _slot_mask(count, kmax: int):
    """(L, kmax) True where the slot holds a face: s < min(count, kmax)."""
    ar = torch.arange(kmax, device=count.device)
    return ar[None, :] < torch.clamp_max(count, kmax)[:, None]


def _recon(P, count, lines, kmax: int):
    """Gathered slot coordinates P (L, kmax, nnei, 3) -> the weighted
    reconstruction sum_i w_i p_i (L, kmax, 3), 0 on empty slots. Weights
    w_i = d_i / sum_j d_j from the point-line distances recomputed against
    the lines, in the JAX ``recon_rows`` order."""
    nnei = P.shape[2]
    dirs = [lines[:, None, c] for c in range(3)]
    x0 = [lines[:, None, 3 + c] for c in range(3)]
    d = []
    for i in range(nnei):
        diff = [P[:, :, i, c] - x0[c] for c in range(3)]
        d_ac = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        proj = diff[0] * dirs[0] + diff[1] * dirs[1] + diff[2] * dirs[2]
        d.append(sqrt_rn(torch.clamp_min(d_ac - proj * proj + 2e-4, 0.0)))
    dsum = d[0]
    for i in range(1, nnei):
        dsum = dsum + d[i]
    w = [d[i] / dsum for i in range(nnei)]
    filled = _slot_mask(count, kmax)
    rows = []
    for c in range(3):
        acc = w[0] * P[:, :, 0, c]
        for i in range(1, nnei):
            acc = acc + w[i] * P[:, :, i, c]
        rows.append(torch.where(filled, acc, 0.0))
    return torch.stack(rows, dim=-1)


def rigid_slots(R, t, point_neis1, point_neis2, lines, kmax: int):
    """Stage 1 and slot reconstruction of the rigid path ->
    (pts1 (L, kmax, 3), pts2 (L, kmax, 3), c1 (L,), c2 (L,)).

    Stage 1 sees the already-transformed cloud 1 (detached), so its
    reconstruction is un-transformed with the detached (R, t) and
    re-transformed with the traced ones: the only place gradients enter."""
    nnei = point_neis1.shape[1] // 3
    with torch.no_grad():
        lines = lines.detach()
        neis1_t = (point_neis1.reshape(-1, 3) @ R + t).reshape(point_neis1.shape)
        neis2 = point_neis2.detach()
        count, _idx, pts = IK.intersect_stage1_pair_pts(
            neis1_t, neis2, lines, neighborhood_delta(neis1_t),
            neighborhood_delta(neis2), kmax=kmax)
        c1, c2 = count[0], count[1]
        r1 = _recon(pts[0], c1, lines, kmax)
        r2 = _recon(pts[1], c2, lines, kmax)
        Rd, td = R.detach(), t.detach()
        u = [r1[..., k] - td[k] for k in range(3)]
        raw = [u[0] * Rd[c, 0] + u[1] * Rd[c, 1] + u[2] * Rd[c, 2]
               for c in range(3)]                      # (v - t) @ R^T
    filled1 = _slot_mask(c1, kmax)
    fwd = [raw[0] * R[0, c] + raw[1] * R[1, c] + raw[2] * R[2, c] + t[c]
           for c in range(3)]                          # raw @ R + t
    pts1 = torch.stack([torch.where(filled1, f / nnei, 0.0) for f in fwd],
                       dim=-1)
    pts2 = torch.where(_slot_mask(c2, kmax)[..., None], r2 / nnei, 0.0)
    return pts1, pts2, c1, c2


def _masked_lower_median(values, mask):
    """torch.median semantics on a masked flat set: the (n-1)//2-th order
    statistic of the valid entries, read with a device-side gather (no host
    sync)."""
    flat = torch.where(mask, values, torch.inf).reshape(-1)
    srt = torch.sort(flat).values
    k = torch.clamp_min((mask.sum() - 1) // 2, 0)
    return srt.gather(0, k.reshape(1)).reshape(())


def stage2(pts1, pts2, c1, c2, kmin: int, kmax: int):
    """The robust loss from slot points (L, kmax, 3) and per-line counts.
    Returns (loss, valid); valid is False when no line is usable (the
    reference's no-intersection sentinel)."""
    lvalid = (c1 >= kmin) & (c1 <= kmax) & (c2 >= kmin) & (c2 <= kmax)
    slot_ok1 = _slot_mask(c1, kmax) & lvalid[:, None]
    slot_ok2 = _slot_mask(c2, kmax) & lvalid[:, None]
    diff = [pts1[:, :, None, c] - pts2[:, None, :, c] for c in range(3)]
    D = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]  # (L, K, K)
    pair_ok = slot_ok1[:, :, None] & slot_ok2[:, None, :]
    median = _masked_lower_median(D.detach(), pair_ok)

    rowmin = torch.where(slot_ok2[:, None, :], D, torch.inf).amin(dim=2)
    colmin = torch.where(slot_ok1[:, :, None], D, torch.inf).amin(dim=1)

    # lines per (k, j) combo; invalid lines go to the extra last bucket
    nC = kmax - kmin + 1
    cid = torch.where(lvalid, (c1 - kmin) * nC + (c2 - kmin), nC * nC).long()
    n_combo = torch.zeros(nC * nC + 1, dtype=torch.int32, device=c1.device)
    n_combo.scatter_add_(0, cid, torch.ones_like(cid, dtype=torch.int32))
    n_nonempty = (n_combo[:nC * nC] > 0).sum()
    n_line = torch.where(lvalid, n_combo[cid], 1)

    row_w = torch.where(slot_ok1, welsch(rowmin, median), 0.0)
    col_w = torch.where(slot_ok2, welsch(colmin, median), 0.0)
    row_sum, col_sum = row_w[:, 0], col_w[:, 0]
    for s in range(1, kmax):
        row_sum = row_sum + row_w[:, s]
        col_sum = col_sum + col_w[:, s]
    row_term = row_sum / (n_line * torch.clamp_min(c1, 1).float())
    col_term = col_sum / (n_line * torch.clamp_min(c2, 1).float())
    w_line = torch.exp(-0.5 * (c1 - c2).abs().float())
    per_line = torch.where(lvalid, w_line * (row_term + col_term), 0.0)
    loss = per_line.sum() / torch.clamp_min(n_nonempty, 1).float()
    return loss, n_nonempty > 0


def intersection_loss_rigid(R, t, point_neis1, point_neis2, lines,
                            kmin: int = 1, kmax: int = 4):
    """The metric with cloud 1 rigidly transformed, p' = p @ R + t (row
    convention). point_neis1/2 (F, nnei*3); lines (L, 6). Returns (loss,
    valid) as device tensors; the gradient flows to R and t."""
    pts1, pts2, c1, c2 = rigid_slots(R, t, point_neis1, point_neis2, lines,
                                     kmax)
    return stage2(pts1, pts2, c1, c2, kmin, kmax)
