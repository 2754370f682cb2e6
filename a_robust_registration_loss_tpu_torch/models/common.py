"""Shared model components: quaternions, batched 3x3 SVD orientation
solving, weighted Kabsch, and the reference networks' LayerNorm and
GroupNorm.

Port of ``a_robust_registration_loss_tpu/models/common.py``. Point tensors
are channels-last (B, N, 3) as there. Every matrix product is a plain fp32
``torch.matmul`` (TF32 is off, ``_device.py``): the counterpart of the JAX
package's HIGHEST precision.

Singular vectors are defined up to sign, and cuSOLVER, LAPACK and XLA pick
differently: only the rotation R = V S U^T is comparable between them.

Mixed precision (a config's ``dtype="bfloat16"``) follows the JAX package's
placement, which is flax's: a network's activations carry the compute
dtype, set by one cast where the network starts (``lower``); each
product (``dense``, ``Linear``, the models' pointwise layers) casts its
fp32 weight to the activation's dtype, multiplies in it and then adds the
bias as an operation of its own, two roundings as ``nn.Dense(dtype=bf16)``
has; the norms take fp32 statistics and cast their result back once to the
input's dtype. Parameters stay fp32, and autograd brings their gradients
back to fp32 through the casts. ``torch.autocast`` is not used: it returns
the norms in fp32 and has no per-call fp32 pin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """A config's ``dtype`` ("float32" or "bfloat16") as a torch dtype;
    any other name raises."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} is neither 'float32' nor 'bfloat16'")
    return DTYPES[name]


def lower(x, dtype: torch.dtype):
    """x cast to the compute dtype ``dtype`` where that is bf16; a float32
    compute dtype leaves x as it is (a float64 copy of a model, the tests'
    reference, stays float64)."""
    return x.to(dtype) if dtype == torch.bfloat16 else x


def upcast(x):
    """A bf16 x back to fp32; any other x as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _cast_back(y, dtype):
    """y in ``dtype``; no operation at all where it is already (a no-op
    ``to`` would still show in a trace, under the next node's sequence
    number)."""
    return y if y.dtype == dtype else y.to(dtype)


def dense(x, weight, bias=None):
    """x @ weight^T (+ bias) in x's dtype, flax ``nn.Dense``'s arithmetic:
    outside bf16 one ``F.linear``; in bf16 the fp32 weight is cast to bf16,
    the product is rounded to bf16 (accumulated in fp32: ``_device.py``),
    and the bias, cast to bf16, is added after it."""
    if x.dtype != torch.bfloat16:
        return F.linear(x, weight, bias)
    y = F.linear(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


def attention_scale(d_k: int, dtype: torch.dtype) -> float:
    """sqrt(d_k) rounded to ``dtype``, the divisor of the attention and
    correspondence scores (``jnp.sqrt(jnp.asarray(d_k, dtype))``): in bf16
    11.3125 for d_k = 128 and 22.625 for 512."""
    return float(torch.tensor(float(d_k), dtype=dtype).sqrt())


class Linear(nn.Linear):
    """``nn.Linear`` (the same parameters) whose product runs in its input's
    dtype: ``dense``."""

    def forward(self, x):
        return dense(x, self.weight, self.bias)


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

    H: (..., 3, 3) -> proper rotations (..., 3, 3). A sample whose H is not
    finite gets a NaN rotation, as the JAX package's SVD gives, where
    LAPACK and cuSOLVER would raise: a poisoned batch then reaches the
    trainer's finiteness guard (``train/harness.py:guarded_update``)."""
    finite = torch.isfinite(H).all(dim=-1).all(dim=-1)[..., None, None]
    U, _, Vh = torch.linalg.svd(torch.where(finite, H, torch.eye(3, dtype=H.dtype,
                                                                 device=H.device)))
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    flip = torch.ones_like(V)
    flip[..., :, 2] = torch.where(det < 0, -1.0, 1.0)[..., None]
    return torch.where(finite, (V * flip) @ Ut, float("nan"))


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
    Parameters ``a_2`` and ``b_2``, the reference's names. Computed in fp32,
    the result cast back to x's dtype."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(features))
        self.b_2 = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        d = x.shape[-1]
        x32 = upcast(x)
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mean) ** 2).sum(dim=-1, keepdim=True) / (d - 1)
        return _cast_back(self.a_2 * (x32 - mean) / (torch.sqrt(var) + self.eps) + self.b_2,
                          x.dtype)


class TorchGroupNorm(nn.Module):
    """GroupNorm (eps 1e-5) over the trailing channel axis of channels-last
    features: (B, N, C), (B, N, k, C) or pooled (B, C). The statistics of a
    group run over all its positions and channels of one sample, as
    ``nn.GroupNorm`` takes them on channels-first input. Parameters
    ``weight`` and ``bias``. As flax's ``GroupNorm``: statistics in fp32,
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias in fp32, cast once
    to x's dtype."""

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
        G = self.num_groups
        g = upcast(x).reshape(B, -1, G, C // G)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (g - mean) * mul + self.bias.reshape(G, C // G)
        return _cast_back(y.reshape(x.shape), x.dtype)
