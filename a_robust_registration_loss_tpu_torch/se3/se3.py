"""SE(3): rigid transforms and twists, batched by broadcasting.

Port of ``a_robust_registration_loss_tpu/se3/se3.py``. A twist is
``x = (w, v)`` with rotation first; ``exp`` returns a 4x4 homogeneous
matrix; ``exp3`` returns the (R, t) pair applied as ``points @ R + t``.
Also the (..., 3, 4) "Rt" helpers of the RPM-Net pipeline.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch.se3 import so3
from a_robust_registration_loss_tpu_torch.se3.sinc import sinc1, sinc2, sinc3


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def twist_prod(x, y):
    """Lie bracket of twists."""
    xw, xv = x[..., 0:3], x[..., 3:6]
    yw, yv = y[..., 0:3], y[..., 3:6]
    zw = _cross(xw, yw)
    zv = _cross(xw, yv) + _cross(xv, yw)
    return torch.cat([zw, zv], dim=-1)


liebracket = twist_prod


def mat(x):
    """hat: (..., 6) -> (..., 4, 4)."""
    W = so3.mat(x[..., 0:3])
    v = x[..., 3:6][..., None]
    top = torch.cat([W, v], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    return torch.cat([top, bottom], dim=-2)


hat = mat


def vec(X):
    """vee: (..., 4, 4) -> (..., 6)."""
    return torch.stack(
        [X[..., 2, 1], X[..., 0, 2], X[..., 1, 0],
         X[..., 0, 3], X[..., 1, 3], X[..., 2, 3]],
        dim=-1,
    )


vee = vec


def genvec():
    return torch.eye(6)


def genmat():
    return mat(genvec())


def _R_V(x):
    w = x[..., 0:3]
    v = x[..., 3:6]
    t = so3.safe_norm(w)[..., None, None]
    W = so3.mat(w)
    S = W @ W
    I = torch.eye(3, dtype=x.dtype, device=x.device)
    R = I + sinc1(t) * W + sinc2(t) * S
    V = I + sinc2(t) * W + sinc3(t) * S
    p = torch.einsum("...ij,...j->...i", V, v)
    return R, p


def _homogeneous(R, p):
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, p[..., None]], dim=-1), bottom], dim=-2)


def exp(x):
    """exp: (..., 6) twist -> (..., 4, 4) homogeneous."""
    return _homogeneous(*_R_V(x))


def exp3(x):
    """exp returning the (R, t) pair, applied as ``points @ R + t``."""
    return _R_V(x)


def inverse(g):
    """(..., 4, 4) -> (..., 4, 4)."""
    R = g[..., :3, :3]
    p = g[..., :3, 3]
    Q = R.transpose(-1, -2)
    q = -torch.einsum("...ij,...j->...i", Q, p)
    return _homogeneous(Q, q)


def log(g):
    """log: (..., 4, 4) -> (..., 6) via so3.log and the inverse left
    Jacobian."""
    R = g[..., :3, :3]
    p = g[..., :3, 3]
    w = so3.log(R)
    H = so3.inv_vecs_Xg_ig(w)
    v = torch.einsum("...ij,...j->...i", H, p)
    return torch.cat([w, v], dim=-1)


def transform(g, a):
    """Apply g (..., 4, 4) to points a (..., 3) or (..., 3, N)."""
    R = g[..., :3, :3]
    p = g[..., :3, 3]
    if g.ndim == a.ndim:
        return R @ a + p[..., None]
    return torch.einsum("...ij,...j->...i", R, a) + p


def group_prod(g, h):
    return g @ h


# (..., 3, 4) "Rt" convention

def rt_identity(batch_shape=(), dtype=torch.float32, device=None):
    """Identity transforms of shape batch_shape + (3, 4)."""
    I = torch.cat([torch.eye(3, dtype=dtype, device=device),
                   torch.zeros((3, 1), dtype=dtype, device=device)], dim=-1)
    return I.expand(tuple(batch_shape) + (3, 4))


def rt_inverse(g):
    """(..., 3, 4) -> (..., 3, 4)."""
    R = g[..., :3, :3]
    t = g[..., :3, 3]
    Rt = R.transpose(-1, -2)
    tt = -torch.einsum("...ij,...j->...i", Rt, t)
    return torch.cat([Rt, tt[..., None]], dim=-1)


def rt_concatenate(a, b):
    """The composition a . b of two (..., 3, 4) transforms."""
    Ra, ta = a[..., :3, :3], a[..., :3, 3]
    Rb, tb = b[..., :3, :3], b[..., :3, 3]
    R = Ra @ Rb
    t = torch.einsum("...ij,...j->...i", Ra, tb) + ta
    return torch.cat([R, t[..., None]], dim=-1)


def rt_transform(g, pts):
    """Apply g (..., 3, 4) to pts (..., N, 3)."""
    R = g[..., :3, :3]
    t = g[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]
