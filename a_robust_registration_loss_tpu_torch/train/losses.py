"""The trainers' metric glue: per-batch line resampling and the per-sample
metric of a batch.

Port of the part of ``a_robust_registration_loss_tpu/train/losses.py`` that
the DCP, RPM-Net and FMR loss compositions share: ``LossConfig``,
``batch_lines``, ``_metric_batch``, ``_metric_batch_rt`` and
``_flat_neis``. The compositions themselves (``dcp_cal_loss`` and the
others) need the models and are not here yet.

The tensor's device picks kernel or plain version, so ``LossConfig`` has no
``backend``; stage 1 never chunks its lines, so it has no ``line_chunk``;
the line-sharded (sp) path and its ``mesh`` are not ported. A sample with no
usable line contributes 0 under its validity mask (the reference would crash
adding None, loss.py:232).
"""

from __future__ import annotations

import dataclasses

import torch

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
    Returns (B, n_lines, 6). One resampler launch per sample."""
    radius = radius_scale * torch.linalg.vector_norm(tar_box[:, 0] - tar_box[:, -1], dim=-1)
    v1, v2 = verts1.detach(), verts2.detach()
    return torch.stack([LN.resample_lines(u4[b], radius[b], centers[b], n_lines,
                                          v1[b], v2[b])
                        for b in range(u4.shape[0])])


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
