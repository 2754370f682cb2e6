"""FMR (Feature-Metric Registration) as ``nn.Module``s, channels-last.

Port of ``a_robust_registration_loss_tpu/models/fmr.py``: the
inverse-compositional (IC) Lucas-Kanade solver with a finite-difference
Jacobian over 6 learnable twist steps, run as a fixed-length loop whose
stop test stays on the device.

- Encoder: PointNet, pointwise layers 3-64-64-64-128-dim_k with
  GroupNorm(8) + ReLU, then a max pool over the points.
- Decoder: FC dim_k-dim_k-dim_k/2-dim_k/4-3N with GroupNorm(8) + ReLU,
  then tanh * 10, reshaped as the reference does: (B, 3, N), transposed to
  (B, N, 3).
- ``SolveRegistration.forward(p0=target, p1=source, maxiter)``: both clouds
  zero-meaned with the bookkeeping transforms a0 / a1; f0 = enc(p0); the
  Jacobian J[b, :, k] = (f0 - enc(exp(-e_k dt_k) p0)) / dt_k as ONE encoder
  pass over the B * 6 perturbed clouds; H = J^T J with the singular guard;
  pinv = H^-1 J^T; maxiter IC updates g <- exp(dx) g, frozen once
  max ||dx|| < xtol; g and every iterate un-normalised as a0 g a1.

The singular guard: a sample whose H is not finite, whose inverse is not
finite or whose condition number reaches 1e8 gets a zero pinv (dx = 0, g
stays the identity) and is counted in ``n_singular``, the JAX package's
rule. ``torch.linalg.inv`` raises on a singular matrix (and its check
waits for the device), and LAPACK and cuSOLVER refuse a NaN matrix, so a
non-finite H is replaced by I before ``inv_ex`` and ``svdvals``, and
``inv_ex``'s info is ignored: ``ok`` and ``n_singular`` stay on the device.
``svdvals`` is cuSOLVER's on the card and waits for it, so the forward is
``post_solve(solve(pre_solve(p0, p1)), maxiter)`` and the trainers' CUDA
graphs capture the pieces around ``solve`` (``train/harness.py:Split``).

Parameter names and shapes are the reference PyTorch FMR's
(``encoder.h1.0.weight`` (64, 3, 1), ``encoder.h2.7.weight``,
``decoder.fc4.bias``, ``decoder.bn3.weight``, ``dt``), so a reference
checkpoint is a plain ``load_state_dict``; a ``dt`` of any shape of 6
values is read as (1, 6). ``models/transplant.py:fmr_from_flax`` brings the
JAX package's tree into these names. TF32 is off (``_device.py``): the
Jacobian subtracts near-equal features, so the rounding of the features is
amplified about 1 / dt = 100 times.

Mixed precision (``FMRConfig.dtype="bfloat16"``), as the JAX package places
it: bf16 covers only the autoencoder branch, the ``f1_full`` encoder pass
and the decoder (its last layer cast to fp32 before tanh * 10). Every
encoder pass that feeds the IC solver (f0, the Jacobian's B * 6 clouds,
the iterations' residuals) is pinned to fp32 by the encoder's per-call
``dtype``, and the pooled features come back fp32 either way. The
parameters stay fp32.

Convention: p1 = source, p0 = target; g maps p1 onto p0.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from a_robust_registration_loss_tpu_torch.models.common import (
    Linear,
    TorchGroupNorm,
    compute_dtype,
    dense,
    lower,
    upcast,
)
from a_robust_registration_loss_tpu_torch.models.dcp import Pointwise
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.se3 import se3


@dataclasses.dataclass(frozen=True)
class FMRConfig:
    dim_k: int = 1024
    num_points: int = 2048   # decoder output size
    maxiter: int = 5         # train default (eval uses 10)
    xtol: float = 1.0e-7
    use_decoder: bool = True
    # the autoencoder branch's compute dtype (module docstring)
    dtype: str = "float32"

    def __post_init__(self):
        compute_dtype(self.dtype)


class PointwiseBias(Pointwise):
    """A 1x1 ``Conv1d`` (or, with ``kernel_dims=2``, ``Conv2d``) with bias on
    channels-last features: weight (out, in, 1) or (out, in, 1, 1), bias
    (out,). The product runs in x's dtype (``dense``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_dims: int = 1):
        super().__init__(in_channels, out_channels, kernel_dims)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        return dense(x, self.weight.flatten(1), self.bias)


def _stack(widths):
    layers = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        layers += [PointwiseBias(cin, cout), TorchGroupNorm(8, cout), nn.ReLU()]
    return nn.Sequential(*layers)


class PointNetEncoder(nn.Module):
    """(B, N, 3) -> (B, dim_k), fp32 at most: ``h1`` (3-64-64) and ``h2``
    (64-64-128-dim_k) as the reference's Sequentials, then the max over the
    points. ``dtype`` overrides the compute dtype for one call (the solver
    pins its passes to fp32)."""

    def __init__(self, dim_k: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.h1 = _stack([3, 64, 64])
        self.h2 = _stack([64, 64, 128, dim_k])

    def forward(self, points, dtype: torch.dtype | None = None):
        x = lower(points, self.dtype if dtype is None else dtype)
        return upcast(self.h2(self.h1(x)).amax(dim=1))


class Decoder(nn.Module):
    """(B, bottleneck) -> (B, num_points, 3), fp32 at most, computing in ``dtype``
    up to the last layer's output."""

    def __init__(self, num_points: int = 2048, bottleneck: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_points = num_points
        self.dtype = dtype
        widths = [bottleneck, bottleneck, bottleneck // 2, bottleneck // 4]
        for i in range(3):
            setattr(self, f"fc{i + 1}", Linear(widths[i], widths[i + 1]))
            setattr(self, f"bn{i + 1}", TorchGroupNorm(8, widths[i + 1]))
        self.fc4 = Linear(widths[3], num_points * 3)

    def forward(self, x):
        x = lower(x, self.dtype)
        for i in range(1, 4):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        x = torch.tanh(upcast(self.fc4(x))) * 10.0  # the points back in fp32
        # the reference reshapes to (B, 3, N), then transposes
        return x.reshape(-1, 3, self.num_points).transpose(1, 2)


def ae_chamfer(a, b):
    """The AE branch's chamfer: the mean of each direction's nearest squared
    distance, summed."""
    d = G.square_distance(a, b)
    return d.amin(dim=1).mean() + d.amin(dim=2).mean()


class SolveRegistration(nn.Module):
    """The IC solver. forward(p0=target, p1=source) returns a dict: the
    un-normalised ``g`` (B, 4, 4), ``g_series`` (maxiter, B, 4, 4) attached
    to the graph, the final feature residual ``r`` (B, dim_k),
    ``loss_ende`` (0-d) and ``n_singular`` (0-d int64), all on the
    device."""

    def __init__(self, cfg: FMRConfig = FMRConfig()):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg.dtype)
        self.encoder = PointNetEncoder(cfg.dim_k, dtype)
        self.decoder = Decoder(cfg.num_points, cfg.dim_k, dtype) if cfg.use_decoder else None
        self.dt = nn.Parameter(torch.full((1, 6), 1.0e-2))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "dt"
        if key in state_dict:
            state_dict[key] = state_dict[key].reshape(1, 6)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _approx_jac(self, p0, f0, dt):
        """J[b, :, k] = (f0 - enc(exp(-e_k dt_k) p0)) / dt_k, one encoder
        pass over the B * 6 perturbed clouds, in fp32."""
        B, N, _ = p0.shape
        twists = -torch.eye(6, dtype=p0.dtype, device=p0.device)[None] * dt[:, None, :]
        D = se3.exp(twists)  # (B, 6, 4, 4)
        p = se3.transform(D[:, :, None], p0[:, None])  # (B, 6, N, 3)
        f = self.encoder(p.reshape(B * 6, N, 3), torch.float32)
        f = f.reshape(B, 6, -1).transpose(1, 2)
        return (f0[..., None] - f) / dt[:, None, :]

    def pre_solve(self, p0, p1):
        """The forward up to the condition number's ``svdvals``: (H_safe,
        Hinv, Jt, finite, f0, q1, a0, a1, loss_ende)."""
        B = p0.shape[0]
        dev, dtype = p0.device, p0.dtype

        p0_m = p0.mean(dim=1)
        p1_m = p1.mean(dim=1)
        q0 = p0 - p0_m[:, None]
        q1 = p1 - p1_m[:, None]
        eye4 = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)
        a0 = eye4.clone()
        a0[:, :3, 3] = p0_m
        a1 = eye4.clone()
        a1[:, :3, 3] = -p1_m

        f0 = self.encoder(q0, torch.float32)  # feeds the solver: fp32
        loss_ende = torch.zeros((), dtype=dtype, device=dev)
        if self.decoder is not None:
            f1_full = self.encoder(q1)  # the autoencoder branch: the config's dtype
            loss_ende = (ae_chamfer(q0, self.decoder(f0))
                         + ae_chamfer(q1, self.decoder(f1_full)))

        dt = self.dt.expand(B, 6)
        J = self._approx_jac(q0, f0, dt)  # (B, K, 6)
        Jt = J.transpose(1, 2)
        H = Jt @ J  # (B, 6, 6)
        finite = torch.isfinite(H).all(dim=-1).all(dim=-1)
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        H_safe = torch.where(finite[:, None, None], H, eye6)
        Hinv = torch.linalg.inv_ex(H_safe)[0]
        return H_safe, Hinv, Jt, finite, f0, q1, a0, a1, loss_ende

    @staticmethod
    def solve(pre):
        """``pre_solve``'s tuple and H's singular values (B, 6), descending
        (eager: ``svdvals`` waits on the host)."""
        return (*pre, torch.linalg.svdvals(pre[0].detach()))

    def post_solve(self, solved, maxiter: int | None = None):
        """``solve``'s tuple -> the forward's dict: the singular guard, then
        maxiter IC updates."""
        cfg = self.cfg
        maxiter = cfg.maxiter if maxiter is None else maxiter
        _, Hinv, Jt, finite, f0, q1, a0, a1, loss_ende, sv = solved
        dev, dtype = q1.device, q1.dtype
        cond = sv[:, 0] / sv[:, -1].clamp_min(torch.finfo(dtype).tiny)
        ok = finite & torch.isfinite(Hinv).all(dim=-1).all(dim=-1) & (cond < 1e8)
        n_singular = (~ok).sum()
        pinv = torch.where(ok[:, None, None], Hinv, 0.0) @ Jt  # (B, 6, K)

        g = torch.eye(4, dtype=dtype, device=dev).expand(a0.shape)
        g_series = []
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        r = None
        for _ in range(maxiter):
            f1 = self.encoder(se3.transform(g[:, None], q1), torch.float32)
            r_new = f1 - f0
            r = r_new if r is None else torch.where(stopped, r, r_new)
            dx = -(pinv @ r[..., None])[..., 0]  # (B, 6)
            stopped = stopped | (torch.linalg.vector_norm(dx, dim=1).amax() < cfg.xtol)
            g = torch.where(stopped, g, se3.exp(dx) @ g)
            g_series.append(g)

        g_series = torch.stack([a0 @ gg @ a1 for gg in g_series])  # (maxiter, B, 4, 4)
        return dict(g=g_series[-1], g_series=g_series, r=r, loss_ende=loss_ende,
                    n_singular=n_singular)

    def forward(self, p0, p1, maxiter: int | None = None):
        return self.post_solve(self.solve(self.pre_solve(p0, p1)), maxiter)
