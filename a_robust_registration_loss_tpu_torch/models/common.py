"""Shared model components: quaternions, batched 3x3 SVD orientation
solving, weighted Kabsch, and the reference networks' LayerNorm and
GroupNorm.

Port of ``a_robust_registration_loss_tpu/models/common.py``. Point tensors
are channels-last (B, N, 3) as there. Every matrix product is a plain fp32
``torch.matmul`` (TF32 is off, ``_device.py``): the counterpart of the JAX
package's HIGHEST precision.

Singular vectors are defined up to sign, and cuSOLVER, LAPACK and XLA pick
differently: only the rotation R = V S U^T is comparable between them.
"""

from __future__ import annotations

import torch
from torch import nn


def quat2mat(quat):
    """Unit quaternion -> rotation matrix with the reference's (x, y, z, w)
    component order, not the usual (w, x, y, z). (..., 4) -> (..., 3, 3)."""
    x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return rot.reshape(quat.shape[:-1] + (3, 3))


def svd_orientation(H):
    """R = V diag(1, 1, det) U^T from H = src_c^T corr_c, with the
    reflection fix: where det(V U^T) < 0, V's last column is flipped.

    H: (..., 3, 3) -> proper rotations (..., 3, 3)."""
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    flip = torch.ones_like(V)
    flip[..., :, 2] = torch.where(det < 0, -1.0, 1.0)[..., None]
    return (V * flip) @ Ut


def weighted_kabsch(a, b, weights):
    """Weighted rigid alignment a -> b. a, b: (B, N, 3); weights (B, N),
    nonnegative. Returns (B, 3, 4) [R | t]."""
    w = weights[..., None] / torch.clamp_min(
        weights.sum(dim=1, keepdim=True)[..., None], 1e-5)
    ca = (a * w).sum(dim=1, keepdim=True)
    cb = (b * w).sum(dim=1, keepdim=True)
    a_c, b_c = a - ca, b - cb
    H = torch.einsum("bnc,bn,bnd->bcd", a_c, weights, b_c)
    R = svd_orientation(H)
    t = -torch.einsum("bij,bj->bi", R, ca[:, 0]) + cb[:, 0]
    return torch.cat([R, t[..., None]], dim=-1)


class TorchLayerNorm(nn.Module):
    """The reference transformer's LayerNorm: a * (x - mean) / (std + eps)
    + b with the unbiased std and eps added to the std, not the variance.
    Parameters ``a_2`` and ``b_2``, the reference's names."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(features))
        self.b_2 = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        d = x.shape[-1]
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).sum(dim=-1, keepdim=True) / (d - 1)
        return self.a_2 * (x - mean) / (torch.sqrt(var) + self.eps) + self.b_2


class TorchGroupNorm(nn.Module):
    """GroupNorm (eps 1e-5) over the trailing channel axis of channels-last
    features: (B, N, C), (B, N, k, C) or pooled (B, C). The statistics of a
    group run over all its positions and channels of one sample, as
    ``nn.GroupNorm`` takes them on channels-first input. Parameters
    ``weight`` and ``bias``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into "
                             f"{num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        g = x.reshape(B, -1, self.num_groups, C // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        y = (g - mean) * torch.rsqrt(var + self.eps)
        return y.reshape(x.shape) * self.weight + self.bias
