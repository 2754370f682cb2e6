"""Registration accuracy metrics: the monitoring oracles of the trainers.

Port of ``a_robust_registration_loss_tpu/eval/metrics.py``: closed-form
extrinsic Euler angles ('xyz' and 'zyx', in degrees, as
``scipy.spatial.transform.Rotation.as_euler`` gives them), the rotation and
translation MSE / MAE monitors, the point-pair-wise errors, the logged-only
supervised loss, and FMR's twist-error metric on the port's ``se3.log``.
Everything takes batched tensors on any device.
"""

from __future__ import annotations

import math

import torch

from a_robust_registration_loss_tpu_torch.se3 import se3


def mat2euler(mats, seq: str = "zyx", degrees: bool = True):
    """Rotation matrices (..., 3, 3) -> extrinsic Euler angles (..., 3) in
    the sequence's axis order, for seq in {'xyz', 'zyx'}."""
    R = mats
    if seq == "xyz":
        # R = Rz(c) @ Ry(b) @ Rx(a); returns [a, b, c]
        a = torch.atan2(R[..., 2, 1], R[..., 2, 2])
        b = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
        c = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    elif seq == "zyx":
        # R = Rx(c) @ Ry(b) @ Rz(a); returns [a, b, c]
        a = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
        b = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
        c = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    else:
        raise ValueError(f"unsupported euler sequence: {seq!r}")
    ang = torch.stack([a, b, c], dim=-1)
    if degrees:
        ang = ang * (180.0 / math.pi)
    return ang


def rotation_euler_errors(R_pred, R_gt, seq: str = "xyz"):
    """(MAE, RMSE) of the Euler angles in degrees. R_pred, R_gt:
    (..., 3, 3)."""
    diff = mat2euler(R_pred, seq) - mat2euler(R_gt, seq)
    return diff.abs().mean(), torch.sqrt((diff**2).mean())


def rotation_mse(R_pred, R_gt):
    return ((R_pred - R_gt) ** 2).mean()


def translation_mse(t_pred, t_gt):
    return ((t_pred - t_gt) ** 2).mean()


def pp_wise_rmse(pred_pts, gt_pts):
    """Point-pair-wise RMSE sqrt(mean((pred - gt)^2))."""
    return torch.sqrt(((pred_pts - gt_pts) ** 2).mean())


def pp_wise_mae(pred_pts, gt_pts):
    """Point-pair-wise MAE mean(|pred - gt|)."""
    return (pred_pts - gt_pts).abs().mean()


def gt_consistency_loss(R_pred, t_pred, R_gt, t_gt):
    """The logged-only supervised loss mse(R_pred^T @ R_gt, I) +
    mse(t_pred, t_gt). R_* (..., 3, 3), t_* (..., 3)."""
    eye = torch.eye(3, dtype=R_pred.dtype, device=R_pred.device)
    rr = R_pred.transpose(-1, -2) @ R_gt
    return ((rr - eye) ** 2).mean() + ((t_pred - t_gt) ** 2).mean()


def dm_twist_error(g_hat, igt):
    """FMR's eval metric: the mean L2 norm of the twist of g_hat @ igt (the
    identity composition means zero error). g_hat, igt: (B, 4, 4). Returns
    (dm_mean, per-sample dn (B,))."""
    dx = se3.log(g_hat @ igt).reshape(g_hat.shape[0], 6)
    dn = torch.linalg.vector_norm(dx, dim=-1)
    return dn.mean(), dn


def twist_csv_rows(g_hat, igt):
    """FMR eval CSV rows [h_w, h_v, g_w, g_v] = [log(g_hat), -log(igt)]:
    (B, 12)."""
    x_hat = se3.log(g_hat).reshape(-1, 6)
    mx_gt = se3.log(igt).reshape(-1, 6)
    return torch.cat([x_hat, -mx_gt], dim=-1)


TWIST_CSV_HEADER = ",".join(
    ["h_w1", "h_w2", "h_w3", "h_v1", "h_v2", "h_v3",
     "g_w1", "g_w2", "g_w3", "g_v1", "g_v2", "g_v3"]
)
