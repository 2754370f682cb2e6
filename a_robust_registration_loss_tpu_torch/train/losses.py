"""The trainers' metric glue and the DCP, RPM-Net and FMR loss
compositions: per-batch line resampling, the per-sample metric of a batch,
and the unsupervised losses with their monitors.

Port of ``a_robust_registration_loss_tpu/train/losses.py``: what the DCP,
RPM-Net and FMR compositions share (``LossConfig``, ``batch_lines``,
``_metric_batch``, ``_metric_batch_rt``, ``_flat_neis``) and DCP's
composition (``dcp_transform``, ``dcp_cal_loss``, ``dcp_cycle_loss``,
``dcp_train_loss``): 15,000 lines resampled once per batch at radius 0.5 x
the target box's diagonal, the per-sample metric / 5.0 summed then / batch
size, optionally + 0.1 x the cycle loss, and a battery of monitors against
the ground truth that are logged and never optimised; and FMR's
(``fmr_train_loss``): 15,000 lines drawn once against the last IC
iterate's source at radius scale 0.5, the metric on the last 3 iterates
discounted 0.5^(maxiter - i - 1), / 5.0 per sample then / batch size,
total = 0.01 x the AE loss + the intersection; and RPM-Net's
(``rpm_cal_loss``, ``rpm_total_loss``): 10,000 lines drawn once against
the source as moved by the first iteration's transform at radius scale
1.0 (the full diagonal), per iteration the summed per-sample metric / the
iteration count and the outlier regularisation, each discounted
0.5^(num_iter - i - 1), total = 10 x reg + 1 x intersection.

Data dicts follow the dataset contract in DCP's form for DCP: ``R``
(B, 3, 3) and ``T`` (B, 3) in column convention, p' = R p + t, as the
predicted (R_ab, t_ab) are; RPM-Net and FMR take the plain contract's
row-convention ``R``. Where the JAX package takes a PRNG key, the functions
here take the uniforms themselves (``u4``, so a test can hand both sides
the same draw) or draw them from a ``torch.Generator``.

The tensor's device picks kernel or plain version, so ``LossConfig`` has no
``backend``; stage 1 never chunks its lines, so it has no ``line_chunk``. A
sample with no usable line contributes 0 under its validity mask (the
reference would crash adding None, loss.py:232).

Under a (dp, sp) mesh (``LossConfig.mesh``, ``parallel/mesh.py``) a batch
holds this rank's dp rows. Every rank draws the uniforms of the global
batch from the same generator, resamples the lines of the whole batch as
the single process does, and keeps its dp rows and sp lines, so the lines
are bit for bit those of one process. Each rank's loss and monitors are
what one process computes on its rows, the means over the dp group give
the global batch's (a sum over the batch, RPM-Net's intersection term, is
scaled by dp to that end; a root-mean-square monitor is the global
batch's, ``dp_rms``), and with sp > 1 the metric runs line-parallel
(``_metric_batch_rt_sp``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from a_robust_registration_loss_tpu_torch.eval import metrics as EM
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.parallel import mesh as PM
from a_robust_registration_loss_tpu_torch.se3 import se3


@dataclasses.dataclass(frozen=True)
class LossConfig:
    n_lines: int = 15000
    kmin: int = 1
    kmax: int = 4
    wt_inliers: float = 1e-2      # rpm/arguments.py (RPM only)
    cycle: bool = False           # DCP optional cycle consistency
    discount: float = 0.5
    # optional parallel.mesh.Mesh under which this rank's batch is its dp
    # rows and the metric sweeps its sp lines (see the module docstring);
    # None = one process
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.kmax < self.kmin or self.kmin < 1:
            raise ValueError(
                f"need 1 <= kmin <= kmax (got kmin={self.kmin}, "
                f"kmax={self.kmax})")


def batch_lines(u4, tar_box, centers, n_lines: int, verts1, verts2,
                radius_scale: float, mesh=None):
    """Per-batch line resampling: n_lines per sample through the sphere of
    radius radius_scale * ||tar_box[b, 0] - tar_box[b, -1]|| at centers[b].

    u4 (B, 4, ROUNDS * n_lines) holds each sample's uniforms (the JAX
    package draws them as ``jax.random.uniform(jax.random.split(key, B)[b],
    (4, ROUNDS * n_lines))``); tar_box (B, 8, 3); centers (B, 3); verts1 the
    predicted-transformed source (B, N, 3), detached, and verts2 the target.
    Returns (B, n_lines, 6). One resampler launch for the batch, where the
    JAX package vmaps its kernel.

    Under a ``mesh`` the other arguments are this rank's dp rows and u4 the
    global batch's uniforms: the rows' spheres and boxes are gathered over
    dp, the resampler runs on the whole batch, as the JAX package
    replicates it, and this rank's dp rows and sp lines are returned,
    (B/dp, n_lines/sp, 6), bit for bit those of one process."""
    radius = radius_scale * torch.linalg.vector_norm(tar_box[:, 0] - tar_box[:, -1], dim=-1)
    v1, v2 = verts1.detach(), verts2.detach()
    if mesh is None:
        return LN.resample_lines(u4, radius, centers, n_lines, v1, v2)
    # the resampler reads only each cloud's box: gather its extremes, whose
    # box is the cloud's bit for bit
    ext = [torch.stack([v.amin(-2), v.amax(-2)], dim=-2) for v in (v1, v2)]
    radius, centers, e1, e2 = (mesh.dp_gather(x) for x in (radius, centers, *ext))
    lines = LN.resample_lines(u4, radius, centers, n_lines, e1, e2)
    return PM.line_shard(PM.dp_rows(lines, mesh), mesh)


def dp_scale(cfg: LossConfig) -> int:
    """dp, or 1 without a mesh: the global batch's rows over this rank's
    (every rank draws the global batch's uniforms), and the factor that
    makes a sum over this rank's rows its share of the global sum in a
    mean over the dp group."""
    return 1 if cfg.mesh is None else cfg.mesh.dp


def dp_rms(rms, cfg: LossConfig):
    """Root-mean-square monitors of this rank's rows (a tensor of them) ->
    the global batch's: the root of the mean over dp of their squares, one
    collective. A mean of the ranks' roots would not be one process's."""
    if cfg.mesh is None or cfg.mesh.dp == 1:
        return rms
    return torch.sqrt(cfg.mesh.dp_mean(rms * rms))


def euler_errors(R_pred, R_gt, cfg: LossConfig):
    """``EM.rotation_euler_errors`` (xyz): (MAE, RMSE) in degrees, the RMSE
    the global batch's under a mesh (``dp_rms``)."""
    mae, rmse = EM.rotation_euler_errors(R_pred, R_gt, seq="xyz")
    return mae, dp_rms(rmse, cfg)


def _metric_batch(src_neis_t, tar_neis, lines, cfg: LossConfig):
    """(B,) per-sample metric values with invalid samples zeroed."""
    losses, valid = M.intersection_loss_batch(src_neis_t, tar_neis, lines,
                                              cfg.kmin, cfg.kmax)
    return torch.where(valid, losses, 0.0)


def _metric_batch_rt(R_row, t, src_neis_raw, tar_neis, lines,
                     cfg: LossConfig):
    """(B,) per-sample metric of ``src_neis @ R_row + t`` against tar, with
    invalid samples zeroed: the rigid path, batched (R_row (B, 3, 3), t
    (B, 3)), one stage-1 launch; the gradient reaches R_row and t. Under a
    mesh with sp > 1, ``lines`` is this rank's line shard and the metric
    runs line-parallel."""
    if cfg.mesh is not None and cfg.mesh.sp > 1:
        return _metric_batch_rt_sp(R_row, t, src_neis_raw, tar_neis, lines, cfg)
    losses, valid = M.intersection_loss_rigid(R_row, t, src_neis_raw, tar_neis,
                                              lines, cfg.kmin, cfg.kmax)
    return torch.where(valid, losses, 0.0)


def _metric_batch_rt_sp(R_row, t, src_neis_raw, tar_neis, lines, cfg: LossConfig):
    """The line-parallel (sp) rigid metric, the JAX package's shard_mapped
    path: stage 1 and the slot reconstruction (``ops/metric.py:
    rigid_slots``) on this rank's L/sp lines, one stage-1 launch; the
    per-line records (both clouds' slot points and counts, 6 kmax + 2
    values a line) gathered over sp in one collective, in sp order; stage 2
    on every sp member. Stage 1 is per line and stage 2 sees the tensors of
    one process, so the values are the unsharded path's bit for bit.

    (R_row, t) enter through ``sp_reduce``: each sp member's backward
    yields its lines' share of their gradient, and the sum over sp gives
    every member the whole of it."""
    mesh, K = cfg.mesh, cfg.kmax
    B, L = lines.shape[:2]
    rt = PM.sp_reduce(torch.cat([R_row.reshape(B, 9), t], dim=-1), mesh)
    pts1, pts2, c1, c2 = M.rigid_slots(rt[:, :9].reshape(B, 3, 3), rt[:, 9:], src_neis_raw,
                                       tar_neis, lines, K)
    # the counts travel as the bits of float32 values: the gather copies
    rec = torch.cat([pts1.reshape(B, L, 3 * K), pts2.reshape(B, L, 3 * K),
                     c1[..., None].view(torch.float32), c2[..., None].view(torch.float32)],
                    dim=-1)
    rec = PM.gather_lines(rec, mesh)
    Lg = rec.shape[1]
    losses, valid = M.stage2(rec[..., :3 * K].reshape(B, Lg, K, 3),
                             rec[..., 3 * K:6 * K].reshape(B, Lg, K, 3),
                             rec[..., 6 * K].contiguous().view(torch.int32),
                             rec[..., 6 * K + 1].contiguous().view(torch.int32),
                             cfg.kmin, cfg.kmax)
    return torch.where(valid, losses, 0.0)


def _flat_neis(neighs):
    """(B, N*nnei, 3) neighbour buffers -> (B, N, nnei*3) metric layout."""
    return neighs.reshape(neighs.shape[0], -1, 9)


# ---------------------------------------------------------------------------
# DCP
# ---------------------------------------------------------------------------

def draw_uniforms(batch: int, n_lines: int, device, generator=None):
    """The resampler's uniforms for a batch, (B, 4, ROUNDS * n_lines), drawn
    on ``device`` (the generator, if given, must live there)."""
    return torch.rand((batch, 4, LN.ROUNDS * n_lines), generator=generator, device=device)


def dcp_transform(points, R, t):
    """Column-convention p' = R p + t on (B, N, 3) points."""
    return torch.einsum("bij,bnj->bni", R, points) + t[:, None, :]


def dcp_cal_loss(data, R_ab, t_ab, cfg: LossConfig = LossConfig(), u4=None,
                 generator=None):
    """The reference's cal_loss: returns (loss_intersection, monitors).
    Only loss_intersection carries a gradient, to R_ab and t_ab through the
    rigid metric; every monitor is detached. ``u4`` (B, 4, ROUNDS *
    cfg.n_lines) are the resampler's uniforms (the global batch's under
    ``cfg.mesh``); when None they are drawn from ``generator``."""
    src = data["points_src_sample"]
    tar = data["points_tar_sample"]
    B = src.shape[0]
    pred_src = dcp_transform(src, R_ab, t_ab)
    src_neis_raw = _flat_neis(data["points_based_neighs_src"])
    tar_neis = _flat_neis(data["points_based_neighs_tar"])

    if u4 is None:
        u4 = draw_uniforms(B * dp_scale(cfg), cfg.n_lines, src.device, generator)
    lines = batch_lines(u4, data["tar_box"], data["centers"], cfg.n_lines,
                        pred_src, tar, radius_scale=0.5, mesh=cfg.mesh)
    # column convention (R p + t) == row form p @ R^T + t
    per_sample = _metric_batch_rt(R_ab.transpose(-1, -2), t_ab, src_neis_raw,
                                  tar_neis, lines, cfg) / 5.0
    loss_intersection = per_sample.sum() / B

    with torch.no_grad():
        gt_src = dcp_transform(src, data["R"], data["T"])
        p, R, t = pred_src.detach(), R_ab.detach(), t_ab.detach()
        mae, rmse = EM.rotation_euler_errors(R, data["R"], seq="xyz")
        pp_wise, rmse = dp_rms(torch.stack([EM.pp_wise_rmse(p, gt_src), rmse]), cfg)
        monitors = dict(
            loss_chamfer=G.chamfer_distance(p, tar),
            loss_pp_wise=pp_wise,
            loss_pp_wise_mae=EM.pp_wise_mae(p, gt_src),
            loss_pp_wise_ori=((src - gt_src) ** 2).mean(),
            loss_pp_wise_identity=EM.pp_wise_mae(p, src),
            loss_rotation=EM.rotation_mse(R, data["R"]),
            loss_translation=EM.translation_mse(t, data["T"]),
            loss_rot_euler_mae=mae,
            loss_rot_euler_rmse=rmse,
            loss_gt=EM.gt_consistency_loss(R, t, data["R"], data["T"]),
        )
    return loss_intersection, monitors


def dcp_cycle_loss(R_ab, t_ab, R_ba, t_ba):
    """Cycle consistency: mse(R_ba R_ab, I) + mean((R_ba^T t_ab + t_ba)^2)."""
    eye = torch.eye(3, dtype=R_ab.dtype, device=R_ab.device)
    rot = ((R_ba @ R_ab - eye) ** 2).mean()
    tr = ((torch.einsum("bij,bi->bj", R_ba, t_ab) + t_ba) ** 2).mean()
    return rot + tr


def dcp_train_loss(data, R_ab, t_ab, R_ba, t_ba, cfg: LossConfig = LossConfig(),
                   u4=None, generator=None):
    """The optimised total: intersection (+ 0.1 * cycle when cfg.cycle).
    Returns (loss, monitors)."""
    loss_inter, monitors = dcp_cal_loss(data, R_ab, t_ab, cfg, u4, generator)
    loss = loss_inter
    if cfg.cycle:
        cyc = dcp_cycle_loss(R_ab, t_ab, R_ba, t_ba)
        loss = loss + 0.1 * cyc
        monitors = dict(monitors, cycle_loss=cyc.detach())
    return loss, dict(monitors, loss_intersection=loss_inter.detach())


# ---------------------------------------------------------------------------
# RPM-Net
# ---------------------------------------------------------------------------

def rpm_cal_loss(pred_transforms, perm_matrices, data,
                 cfg: LossConfig = LossConfig(n_lines=10000), u4=None, generator=None):
    """RPM-Net's losses: returns (losses, the source moved by the last
    iteration's transform).

    pred_transforms: a (B, 3, 4) column-convention transform per iteration;
    perm_matrices: the (B, J, K) Sinkhorn matrix of each; data in the plain
    contract (row-convention ``R``). The lines come from ``u4`` or are drawn
    from ``generator``, once, against the source as moved by the first
    iteration's transform: one resampler launch and one stage-1 launch an
    iteration on the card. losses: ``loss_intersection``, ``loss_reg`` (the
    optimised parts), ``loss_chamfer`` and ``loss_gt`` (detached
    monitors)."""
    num_iter = len(pred_transforms)
    src = data["points_src_sample"][..., :3]
    tar = data["points_tar_sample"]
    src_neis_raw = _flat_neis(data["points_based_neighs_src"])
    tar_neis = _flat_neis(data["points_based_neighs_tar"])
    B = src.shape[0]

    lines = None
    inter_terms, chamfer_terms = [], []
    for g in pred_transforms:
        pred_src = se3.rt_transform(g, src)
        if lines is None:
            if u4 is None:
                u4 = draw_uniforms(B * dp_scale(cfg), cfg.n_lines, src.device, generator)
            lines = batch_lines(u4, data["tar_box"], data["centers"], cfg.n_lines,
                                pred_src, tar, radius_scale=1.0, mesh=cfg.mesh)
        inter = _metric_batch_rt(g[..., :3, :3].transpose(-1, -2), g[..., :3, 3], src_neis_raw,
                                 tar_neis, lines, cfg).sum() * dp_scale(cfg)
        inter_terms.append(inter / num_iter)
        chamfer_terms.append(G.chamfer_distance(tar, pred_src.detach()))

    reg_terms = []
    for perm in perm_matrices:
        ref_outliers = (1.0 - perm.sum(dim=1)) * cfg.wt_inliers
        src_outliers = (1.0 - perm.sum(dim=2)) * cfg.wt_inliers
        reg_terms.append(ref_outliers.mean() + src_outliers.mean())

    def discounted(terms):
        return sum(t * cfg.discount ** (num_iter - ni - 1) for ni, t in enumerate(terms))

    with torch.no_grad():
        # the row-convention ground truth as a column transform [R^T | T]
        g = torch.cat([data["R"].transpose(-1, -2), data["T"][..., None]], dim=-1)
        loss_gt = (se3.rt_transform(g, src) - pred_src).abs().mean()
    losses = dict(loss_intersection=discounted(inter_terms),
                  loss_chamfer=discounted(chamfer_terms),
                  loss_reg=discounted(reg_terms), loss_gt=loss_gt)
    return losses, pred_src


def rpm_total_loss(losses: dict):
    """total = 10 * reg + 1 * intersection."""
    return 10.0 * losses["loss_reg"] + 1.0 * losses["loss_intersection"]


# ---------------------------------------------------------------------------
# FMR
# ---------------------------------------------------------------------------

def fmr_train_loss(g_series, loss_ende, data, cfg: LossConfig = LossConfig(),
                   maxiter: int = 5, u4=None, generator=None):
    """FMR's training total: the intersection metric on the last 3 IC
    iterates with 0.5^(maxiter - i - 1) discounts, its lines drawn once
    (``u4``, or from ``generator``) against the detached final iterate's
    transformed source; total = 0.01 * loss_ende + 1.0 * intersection.
    One resampler launch and 3 stage-1 launches for the batch.

    g_series: (maxiter, B, 4, 4) un-normalised iterates (column convention,
    ``models/fmr.py``); data in the FMR form (row-convention R, ``igt``).
    Returns (total, parts): ``loss_ende``, ``loss_intersection``, and the
    monitors ``loss_pp_wise`` and ``loss_chamfer``, all detached."""
    src = data["points_src_sample"]
    tar = data["points_tar_sample"]
    src_neis_raw = _flat_neis(data["points_based_neighs_src"])
    tar_neis = _flat_neis(data["points_based_neighs_tar"])
    B = src.shape[0]

    g_last = g_series[maxiter - 1].detach()
    pred_src = se3.transform(g_last[:, None], src)
    if u4 is None:
        u4 = draw_uniforms(B * dp_scale(cfg), cfg.n_lines, src.device, generator)
    lines = batch_lines(u4, data["tar_box"], data["centers"], cfg.n_lines,
                        pred_src, tar, radius_scale=0.5, mesh=cfg.mesh)

    loss_inter = 0.0
    for i in range(max(0, maxiter - 3), maxiter):
        gi = g_series[i]
        pred_src = se3.transform(gi[:, None], src)
        tp = (_metric_batch_rt(gi[:, :3, :3].transpose(-1, -2), gi[:, :3, 3], src_neis_raw,
                               tar_neis, lines, cfg) / 5.0).sum()
        loss_inter = loss_inter + tp * cfg.discount ** (maxiter - i - 1)
    loss_inter = loss_inter / B

    with torch.no_grad():
        gt_src = se3.transform(se3.inverse(data["igt"])[:, None], src)
        loss_pp_wise = (se3.transform(g_series[maxiter - 1][:, None], src) - gt_src).abs().mean()
        loss_chamfer = G.chamfer_distance(pred_src.detach(), tar)

    total = 0.01 * loss_ende + 1.0 * loss_inter
    return total, dict(loss_ende=loss_ende.detach(), loss_intersection=loss_inter.detach(),
                       loss_pp_wise=loss_pp_wise, loss_chamfer=loss_chamfer)
