"""The trainers' metric glue and DCP's loss composition: per-batch line
resampling, the per-sample metric of a batch, and DCP's unsupervised loss
with its monitors.

Port of ``a_robust_registration_loss_tpu/train/losses.py``: what the DCP,
RPM-Net and FMR compositions share (``LossConfig``, ``batch_lines``,
``_metric_batch``, ``_metric_batch_rt``, ``_flat_neis``) and DCP's
composition (``dcp_transform``, ``dcp_cal_loss``, ``dcp_cycle_loss``,
``dcp_train_loss``): 15,000 lines resampled once per batch at radius 0.5 x
the target box's diagonal, the per-sample metric / 5.0 summed then / batch
size, optionally + 0.1 x the cycle loss, and a battery of monitors against
the ground truth that are logged and never optimised. RPM-Net's and FMR's
compositions need their models and are not here yet.

Data dicts follow the dataset contract in DCP's form: ``R`` (B, 3, 3) and
``T`` (B, 3) in column convention, p' = R p + t, as the predicted
(R_ab, t_ab) are. Where the JAX package takes a PRNG key, the functions
here take the uniforms themselves (``u4``, so a test can hand both sides
the same draw) or draw them from a ``torch.Generator``.

The tensor's device picks kernel or plain version, so ``LossConfig`` has no
``backend``; stage 1 never chunks its lines, so it has no ``line_chunk``;
the line-sharded (sp) path and its ``mesh`` are not ported. A sample with no
usable line contributes 0 under its validity mask (the reference would crash
adding None, loss.py:232).
"""

from __future__ import annotations

import dataclasses

import torch

from a_robust_registration_loss_tpu_torch.eval import metrics as EM
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops import metric as M


@dataclasses.dataclass(frozen=True)
class LossConfig:
    n_lines: int = 15000
    kmin: int = 1
    kmax: int = 4
    wt_inliers: float = 1e-2      # rpm/arguments.py (RPM only)
    cycle: bool = False           # DCP optional cycle consistency
    discount: float = 0.5

    def __post_init__(self):
        if self.kmax < self.kmin or self.kmin < 1:
            raise ValueError(
                f"need 1 <= kmin <= kmax (got kmin={self.kmin}, "
                f"kmax={self.kmax})")


def batch_lines(u4, tar_box, centers, n_lines: int, verts1, verts2,
                radius_scale: float):
    """Per-batch line resampling: n_lines per sample through the sphere of
    radius radius_scale * ||tar_box[b, 0] - tar_box[b, -1]|| at centers[b].

    u4 (B, 4, ROUNDS * n_lines) holds each sample's uniforms (the JAX
    package draws them as ``jax.random.uniform(jax.random.split(key, B)[b],
    (4, ROUNDS * n_lines))``); tar_box (B, 8, 3); centers (B, 3); verts1 the
    predicted-transformed source (B, N, 3), detached, and verts2 the target.
    Returns (B, n_lines, 6). One resampler launch for the batch, where the
    JAX package vmaps its kernel."""
    radius = radius_scale * torch.linalg.vector_norm(tar_box[:, 0] - tar_box[:, -1], dim=-1)
    return LN.resample_lines(u4, radius, centers, n_lines, verts1.detach(), verts2.detach())


def _metric_batch(src_neis_t, tar_neis, lines, cfg: LossConfig):
    """(B,) per-sample metric values with invalid samples zeroed."""
    losses, valid = M.intersection_loss_batch(src_neis_t, tar_neis, lines,
                                              cfg.kmin, cfg.kmax)
    return torch.where(valid, losses, 0.0)


def _metric_batch_rt(R_row, t, src_neis_raw, tar_neis, lines,
                     cfg: LossConfig):
    """(B,) per-sample metric of ``src_neis @ R_row + t`` against tar, with
    invalid samples zeroed: the rigid path, batched (R_row (B, 3, 3), t
    (B, 3)), one stage-1 launch; the gradient reaches R_row and t."""
    losses, valid = M.intersection_loss_rigid(R_row, t, src_neis_raw, tar_neis,
                                              lines, cfg.kmin, cfg.kmax)
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
    cfg.n_lines) are the resampler's uniforms; when None they are drawn
    from ``generator``."""
    src = data["points_src_sample"]
    tar = data["points_tar_sample"]
    B = src.shape[0]
    pred_src = dcp_transform(src, R_ab, t_ab)
    src_neis_raw = _flat_neis(data["points_based_neighs_src"])
    tar_neis = _flat_neis(data["points_based_neighs_tar"])

    if u4 is None:
        u4 = draw_uniforms(B, cfg.n_lines, src.device, generator)
    lines = batch_lines(u4, data["tar_box"], data["centers"], cfg.n_lines,
                        pred_src, tar, radius_scale=0.5)
    # column convention (R p + t) == row form p @ R^T + t
    per_sample = _metric_batch_rt(R_ab.transpose(-1, -2), t_ab, src_neis_raw,
                                  tar_neis, lines, cfg) / 5.0
    loss_intersection = per_sample.sum() / B

    with torch.no_grad():
        gt_src = dcp_transform(src, data["R"], data["T"])
        p, R, t = pred_src.detach(), R_ab.detach(), t_ab.detach()
        mae, rmse = EM.rotation_euler_errors(R, data["R"], seq="xyz")
        monitors = dict(
            loss_chamfer=G.chamfer_distance(p, tar),
            loss_pp_wise=EM.pp_wise_rmse(p, gt_src),
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
