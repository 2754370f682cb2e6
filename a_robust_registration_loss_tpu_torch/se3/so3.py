"""SO(3): rotations and their Lie algebra, batched by broadcasting.

Port of ``a_robust_registration_loss_tpu/se3/so3.py``: functions take
(..., 3) / (..., 3, 3) tensors; plain autograd through the NaN-safe sinc
primitives gives exact gradients, t = 0 included. ``log`` keeps the
reference's t ~= pi branch (sqrt of the diagonal with sign recovery).
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch.se3.sinc import sinc1, sinc2, sinc3


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def safe_norm(w):
    """|w| with a NaN-free gradient at w = 0."""
    t2 = (w * w).sum(-1)
    zero = t2 == 0
    t = torch.sqrt(torch.where(zero, torch.ones_like(t2), t2))
    return torch.where(zero, torch.zeros_like(t), t)


def cross_prod(x, y):
    return torch.linalg.cross(x, y, dim=-1)


liebracket = cross_prod


def mat(x):
    """hat: (..., 3) -> (..., 3, 3) skew matrix."""
    x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
    zero = torch.zeros_like(x1)
    return torch.stack(
        [
            torch.stack([zero, -x3, x2], dim=-1),
            torch.stack([x3, zero, -x1], dim=-1),
            torch.stack([-x2, x1, zero], dim=-1),
        ],
        dim=-2,
    )


hat = mat


def vec(X):
    """vee: (..., 3, 3) -> (..., 3)."""
    return torch.stack([X[..., 2, 1], X[..., 0, 2], X[..., 1, 0]], dim=-1)


vee = vec


def genvec():
    return torch.eye(3)


def genmat():
    return mat(genvec())


def btrace(X):
    return torch.einsum("...ii->...", X)


def exp(w):
    """Rodrigues exp map (..., 3) -> (..., 3, 3)."""
    t = safe_norm(w)[..., None, None]
    W = mat(w)
    S = W @ W
    return _eye(w) + sinc1(t) * W + sinc2(t) * S


def inverse(R):
    return R.transpose(-1, -2)


def log(R):
    """Log map with the t ~= pi branch. The acos argument is clamped to
    [-1, 1], as in the JAX package."""
    eps = 1.0e-7
    c = torch.clamp((btrace(R) - 1) / 2, -1.0, 1.0)
    t = torch.arccos(c)
    sc = sinc1(t)
    near_pi = sc.abs() <= eps

    # main branch, with the divisor guarded inside the dead region
    sc_safe = torch.where(near_pi, torch.ones_like(sc), sc)[..., None, None]
    X_main = (R - R.transpose(-1, -2)) / (2 * sc_safe)

    # pi branch
    t2 = (t**2)[..., None, None]
    A = (R + _eye(R)) * t2 / 2
    aw1 = torch.sqrt(torch.clamp_min(A[..., 0, 0], 0.0))
    aw2 = torch.sqrt(torch.clamp_min(A[..., 1, 1], 0.0))
    aw3 = torch.sqrt(torch.clamp_min(A[..., 2, 2], 0.0))
    s3 = torch.sign(A[..., 0, 2])
    s23 = torch.sign(A[..., 1, 2])
    sgn_3 = torch.where(s3 == 0, torch.ones_like(s3), s3)
    sgn_23 = torch.where(s23 == 0, torch.ones_like(s23), s23)
    sgn_2 = sgn_23 * sgn_3
    X_pi = mat(torch.stack([aw1, aw2 * sgn_2, aw3 * sgn_3], dim=-1))

    return vec(torch.where(near_pi[..., None, None], X_pi, X_main))


def transform(R, a):
    """Apply rotation: R (..., 3, 3), a (..., 3) or (..., 3, N)."""
    if R.ndim == a.ndim:
        return R @ a
    return torch.einsum("...ij,...j->...i", R, a)


def group_prod(g, h):
    return g @ h


def vecs_Xg_ig(w):
    """Left Jacobian V = I + sinc2 W + sinc3 W^2."""
    t = safe_norm(w)[..., None, None]
    W = mat(w)
    S = W @ W
    return _eye(w) + sinc2(t) * W + sinc3(t) * S


def inv_vecs_Xg_ig(w):
    """Inverse left Jacobian H = I - W/2 + eta(t) W^2,
    eta(t) = (1 - (t/2)/tan(t/2)) / t^2, Taylor O(t^8) for t < 0.01."""
    t = safe_norm(w)[..., None, None]
    W = mat(w)
    S = W @ W
    small = t < 0.01
    t_safe = torch.where(small, torch.ones_like(t), t)
    t2 = t**2
    eta_small = ((t2 / 40 + 1) * t2 / 42 + 1) * t2 / 720 + 1 / 12
    eta_exact = (1 - (t_safe / 2) / torch.tan(t_safe / 2)) / t_safe**2
    eta = torch.where(small, eta_small, eta_exact)
    return _eye(w) - 0.5 * W + eta * S
