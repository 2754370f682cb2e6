"""RPM-Net (early fusion) as ``nn.Module``s, channels-last.

Port of ``a_robust_registration_loss_tpu/models/rpmnet.py``: point clouds
and features are (B, N, C) as there, pointwise convolutions are linear maps
over the trailing axis, Kabsch solves all samples in one batched SVD, and
the registration iterations are a Python loop that detaches the transform
between iterations, as the reference does.

- Hybrid features: a radius ball query of each point that excludes the
  point itself and backfills with it, the neighbours' xyz and normals
  gathered in ONE row gather of the concatenated (B, N, 6) table
  (``ops/cuda/gather.py:gather_rows``: the hand-written kernel on the card,
  its plain version on the CPU), then xyz / dxyz / PPF (angles as
  atan2(|cross|, dot)) through a pointwise net, a max over the neighbours,
  a second pointwise net and an L2 normalisation.
- Annealing parameters: beta, alpha = softplus of a PointNet over the
  0/1-flag-padded union of both clouds, or the learnable-constant ablation
  (``anneal="constant"``).
- Log-domain Sinkhorn with an optional slack row and column, zero-padded
  and not normalised.
- ``compute_rigid_transform``: weights normalised by their sum + 1e-5, the
  covariance of the centred clouds with the normalised weights, and the
  +-V determinant choice (det(R) = 0 takes the flipped V). It is not
  ``models/common.py:weighted_kabsch``, whose normalisation and covariance
  differ. A sample whose covariance is not finite gets the SVD of I and a
  NaN transform, where LAPACK and cuSOLVER would raise, so a poisoned batch
  reaches the trainer's finiteness guard.

forward(xyz_src, norm_src, xyz_ref, norm_ref, num_iter) -> (transforms,
endpoints): a list of (B, 3, 4) transforms, one per iteration, and the
Sinkhorn matrices, beta and alpha of each. Each iteration's SVD reads the
host, so the forward is also given in pieces between them (``pre_solve``,
``solve``, ``step``, ``post_solve``) for the trainers' CUDA graphs.

Parameter names and shapes are those of the reference PyTorch RPM-Net
(``weights_net.prepool.0.weight`` (64, 4, 1), ``feat_extractor.prepool.0.
weight`` (96, 10, 1, 1), ``feat_extractor.postpool.6.bias``, ...), except
that the annealing net's last layer keeps the 2 outputs that the reference
reads of its 2 + prod(weights_dim): ``models/transplant.py:
rpmnet_from_state_dict`` cuts a reference checkpoint to them, and
``rpmnet_from_flax`` brings the JAX package's tree into these names.

Where the work goes on the card: one ball query is a (B, N, N) distance
matrix and a k-selection; the feature net runs on (B, N, k, C) activations
(at the defaults (4, 1,024, 64, 96 to 192), 100 to 200 MB each). The grouped
table is data, never a parameter's function: the points, their normals and
the source moved by a detached transform. So no gradient reaches the
gather, and its backward kernels never run on this path.

Mixed precision (``RPMNetConfig.dtype="bfloat16"``), as the JAX package
places it: the feature nets and the annealing PointNet compute in bf16;
the annealing net's beta / alpha layer runs in fp32, and the features go
back to fp32 before their L2 normalisation and the matching. The ball
query, the PPF geometry (the gather keeps taking the fp32 xyz and
normals), Sinkhorn and Kabsch stay fp32, as do the parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from a_robust_registration_loss_tpu_torch.models.common import (
    Linear,
    TorchGroupNorm,
    compute_dtype,
    lower,
    upcast,
)
from a_robust_registration_loss_tpu_torch.models.fmr import PointwiseBias
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops.cuda import gather as GK

_EPS = 1e-5  # the reference's rpmnet.py:16
# the raw features' channels; they are concatenated in _RAW_ORDER whatever
# the order of ``features``
_RAW_SIZES = {"xyz": 3, "dxyz": 3, "ppf": 4}
_RAW_ORDER = {"xyz": 0, "dxyz": 1, "ppf": 2}


@dataclasses.dataclass(frozen=True)
class RPMNetConfig:
    """The reference CLI's defaults; ``dtype`` the feature nets' and the
    annealing net's compute dtype (module docstring)."""

    features: Sequence[str] = ("ppf", "dxyz", "xyz")
    feat_dim: int = 96
    radius: float = 0.3
    num_neighbors: int = 64
    num_sk_iter: int = 5
    add_slack: bool = True
    anneal: str = "net"  # "net" | "constant"
    dtype: str = "float32"

    def __post_init__(self):
        compute_dtype(self.dtype)
        if self.anneal not in ("net", "constant"):
            raise ValueError(f"RPMNetConfig: anneal {self.anneal!r} is neither 'net' nor "
                             "'constant'")
        unknown = set(self.features) - set(_RAW_SIZES)
        if unknown or not self.features:
            raise ValueError(f"RPMNetConfig: features {tuple(self.features)}; each must be "
                             f"one of {sorted(_RAW_SIZES)}")


def angle(v1, v2):
    """atan2(|v1 x v2|, v1 . v2) over the trailing axis (broadcasting)."""
    cross = torch.linalg.cross(v1, v2, dim=-1)
    return torch.atan2(torch.linalg.vector_norm(cross, dim=-1), (v1 * v2).sum(-1))


def query_ball_point_excl(radius, nsample: int, xyz, new_xyz, itself_indices):
    """Ball query that leaves out the centre point itself and backfills
    with its index: (B, S, nsample) int64 indices into xyz (B, N, 3) for the
    query points new_xyz (B, S, 3), the in-ball ones ascending.

    A point is in the ball where its squared distance, by the inner-product
    expansion, is <= radius^2: a rounding knife edge, on which the CPU, the
    card and XLA may disagree for a pair whose d^2 lies within an ulp or so
    of r^2."""
    N = xyz.shape[1]
    sqrdists = G.square_distance(new_xyz, xyz)
    group_idx = torch.arange(N, device=xyz.device).expand(sqrdists.shape)
    outside = (group_idx == itself_indices[:, :, None]) | (sqrdists > radius**2)
    group_idx = G._smallest_k(torch.where(outside, N, group_idx), nsample)
    return torch.where(group_idx == N, itself_indices[:, :, None], group_idx)


def _group_gather(xyz, normals, idx):
    """The neighbours' xyz and normals for idx (B, S, ns): one row gather of
    the (B, N, 6) table [xyz | normals] at idx flattened to (B, S * ns),
    through ``gather_rows`` (one forward kernel on the card). Returns
    ((B, S, ns, 3), (B, S, ns, 3))."""
    B, S, ns = idx.shape
    table = torch.cat([xyz, normals], dim=-1)
    out = GK.gather_rows(table, idx.reshape(B, S * ns)).reshape(B, S, ns, 6)
    return out[..., :3], out[..., 3:]


def sample_and_group_multi(radius, nsample: int, xyz, normals):
    """xyz / dxyz / ppf cluster features of every point: xyz (B, N, 3),
    dxyz (B, N, ns, 3), ppf (B, N, ns, 4). At a backfilled neighbour d = 0:
    its angles are atan2(0, +-0) and its distance 0, as in the JAX
    package."""
    B, N, _ = xyz.shape
    itself = torch.arange(N, device=xyz.device).expand(B, N)
    idx = query_ball_point_excl(radius, nsample, xyz, xyz, itself)
    grouped_xyz, ni = _group_gather(xyz, normals, idx)
    d = grouped_xyz - xyz[:, :, None, :]
    nr = normals[:, :, None, :]
    ppf = torch.stack([angle(nr, d), angle(ni, d), angle(nr.expand_as(ni), ni),
                       torch.linalg.vector_norm(d, dim=-1)], dim=-1)
    return {"xyz": xyz, "dxyz": d, "ppf": ppf}


def _stack(layers, kernel_dims: int, last_plain: bool = False):
    """Pointwise (with bias) + GroupNorm + ReLU per (in, out, groups), the
    reference's Sequential indices; with ``last_plain`` the last layer is a
    pointwise map alone."""
    mods = []
    for i, (cin, cout, groups) in enumerate(layers):
        mods.append(PointwiseBias(cin, cout, kernel_dims))
        if not (last_plain and i == len(layers) - 1):
            mods += [TorchGroupNorm(groups, cout), nn.ReLU()]
    return nn.Sequential(*mods)


class ParameterPredictionNet(nn.Module):
    """Annealing parameters from a PointNet over both clouds: (B, J, 3),
    (B, K, 3) -> (beta (B,), alpha (B,)), computing in ``dtype`` up to the
    last layer, which runs in fp32."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.prepool = _stack([(4, 64, 8), (64, 64, 8), (64, 64, 8), (64, 128, 8),
                               (128, 1024, 16)], kernel_dims=1)
        self.postpool = nn.Sequential(
            Linear(1024, 512), TorchGroupNorm(16, 512), nn.ReLU(),
            Linear(512, 256), TorchGroupNorm(16, 256), nn.ReLU(),
            nn.Linear(256, 2))

    def forward(self, src, ref):
        x = torch.cat([F.pad(src, (0, 1), value=0.0), F.pad(ref, (0, 1), value=1.0)], dim=1)
        y = self.postpool[:-1](self.prepool(lower(x, self.dtype)).amax(dim=1))
        raw = self.postpool[-1](upcast(y))  # the beta / alpha layer in fp32
        return F.softplus(raw[:, 0]), F.softplus(raw[:, 1])


class ParameterPredictionNetConstant(nn.Module):
    """The learnable-constant ablation: beta, alpha = softplus of a
    2-vector, the same for every sample."""

    def __init__(self):
        super().__init__()
        self.anneal_weights = nn.Parameter(torch.zeros(2))

    def forward(self, src, ref):
        B = src.shape[0]
        return (F.softplus(self.anneal_weights[0]).expand(B),
                F.softplus(self.anneal_weights[1]).expand(B))


class FeatExtractionEarlyFusion(nn.Module):
    """Hybrid per-point features, L2-normalised: (B, N, 3) points and
    normals -> (B, N, feat_dim) fp32; the nets compute in the config's
    dtype, the raw features and the normalisation are fp32."""

    def __init__(self, cfg: RPMNetConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)
        raw = sum(_RAW_SIZES[f] for f in cfg.features)
        out = cfg.feat_dim * 2
        self.prepool = _stack([(raw, out // 2, 8), (out // 2, out // 2, 8), (out // 2, out, 8)],
                              kernel_dims=2)
        self.postpool = _stack([(out, out, 8), (out, cfg.feat_dim, 8),
                                (cfg.feat_dim, cfg.feat_dim, 8)], kernel_dims=1,
                               last_plain=True)

    def forward(self, xyz, normals):
        cfg = self.cfg
        feats = sample_and_group_multi(cfg.radius, cfg.num_neighbors, xyz, normals)
        feats["xyz"] = feats["xyz"][:, :, None, :]
        B, N, ns = xyz.shape[0], xyz.shape[1], cfg.num_neighbors
        x = torch.cat([feats[f].expand(B, N, ns, feats[f].shape[-1])
                       for f in sorted(cfg.features, key=_RAW_ORDER.get)], dim=-1)
        x = upcast(self.postpool(self.prepool(lower(x, self.dtype)).amax(dim=2)))
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def sinkhorn(log_alpha, n_iters: int = 5, slack: bool = True):
    """Log-domain Sinkhorn: log_alpha (B, J, K) -> the log of the
    normalised matrix. With ``slack`` a zero row and column are appended
    and are not normalised themselves."""
    if not slack:
        for _ in range(n_iters):
            log_alpha = log_alpha - torch.logsumexp(log_alpha, dim=2, keepdim=True)
            log_alpha = log_alpha - torch.logsumexp(log_alpha, dim=1, keepdim=True)
        return log_alpha
    padded = F.pad(log_alpha, (0, 1, 0, 1))
    for _ in range(n_iters):
        rows = padded[:, :-1, :] - torch.logsumexp(padded[:, :-1, :], dim=2, keepdim=True)
        padded = torch.cat([rows, padded[:, -1:, :]], dim=1)
        cols = padded[:, :, :-1] - torch.logsumexp(padded[:, :, :-1], dim=1, keepdim=True)
        padded = torch.cat([cols, padded[:, :, -1:]], dim=2)
    return padded[:, :-1, :-1]


def match_features(feat_src, feat_ref):
    """Squared-L2 feature distances (B, J, K)."""
    return G.square_distance(feat_src, feat_ref)


def kabsch_covariance(a, b, weights):
    """``compute_rigid_transform`` up to its SVD: (the covariance (B, 3, 3),
    its finiteness (B, 1, 1), ca, cb)."""
    w = weights[..., None] / (weights[..., None].sum(dim=1, keepdim=True) + _EPS)
    ca = (a * w).sum(dim=1)
    cb = (b * w).sum(dim=1)
    a_c = a - ca[:, None, :]
    b_c = b - cb[:, None, :]
    cov = a_c.transpose(-1, -2) @ (b_c * w)
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)[:, None, None]
    return cov, finite, ca, cb


def kabsch_rotation(cov, finite):
    """The SVD's rotation with the +-V choice, NaN where ``finite`` is not
    (eager in the trainers' CUDA graphs: cuSOLVER waits on the host)."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    U, _, Vh = torch.linalg.svd(torch.where(finite, cov, eye))
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    R_pos = V @ Ut
    R_neg = torch.cat([V[..., :2], -V[..., 2:]], dim=-1) @ Ut
    R = torch.where((torch.linalg.det(R_pos) > 0)[:, None, None], R_pos, R_neg)
    return torch.where(finite, R, float("nan"))


def kabsch_transform(R, ca, cb):
    """(B, 3, 4) [R | t] of the rotation and the weighted centroids."""
    t = -torch.einsum("bij,bj->bi", R, ca) + cb
    return torch.cat([R, t[..., None]], dim=-1)


def compute_rigid_transform(a, b, weights):
    """Weighted Kabsch a -> b: a, b (B, N, 3), weights (B, N) ->
    (B, 3, 4) [R | t]."""
    cov, finite, ca, cb = kabsch_covariance(a, b, weights)
    return kabsch_transform(kabsch_rotation(cov, finite), ca, cb)


def rt_transform_points_normals(g, pts, normals):
    """(B, 3, 4) applied to points (B, N, 3); normals only rotated."""
    R = g[..., :3, :3]
    t = g[..., :3, 3]
    p = torch.einsum("bij,bnj->bni", R, pts) + t[:, None, :]
    n = torch.einsum("bij,bnj->bni", R, normals)
    return p, n


class RPMNetEarlyFusion(nn.Module):
    """The trainable early-fusion RPM-Net."""

    def __init__(self, cfg: RPMNetConfig = RPMNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.weights_net = (ParameterPredictionNetConstant() if cfg.anneal == "constant"
                            else ParameterPredictionNet(compute_dtype(cfg.dtype)))
        self.feat_extractor = FeatExtractionEarlyFusion(cfg)

    def _iteration(self, xyz_src, xyz_ref, norm_ref, xyz_src_t, norm_src_t):
        """One registration iteration up to Kabsch's SVD: (cov, finite, ca,
        cb, perm, beta, alpha)."""
        cfg = self.cfg
        beta, alpha = self.weights_net(xyz_src_t, xyz_ref)
        feat_src = self.feat_extractor(xyz_src_t, norm_src_t)
        feat_ref = self.feat_extractor(xyz_ref, norm_ref)
        dist = match_features(feat_src, feat_ref)
        affinity = -beta[:, None, None] * (dist - alpha[:, None, None])
        perm = torch.exp(sinkhorn(affinity, cfg.num_sk_iter, cfg.add_slack))
        weighted_ref = (perm @ xyz_ref) / (perm.sum(dim=2, keepdim=True) + _EPS)
        return (*kabsch_covariance(xyz_src, weighted_ref, perm.sum(dim=2)), perm, beta, alpha)

    def pre_solve(self, xyz_src, norm_src, xyz_ref, norm_ref):
        """The first iteration up to its SVD. The forward is ``pre_solve``,
        then ``solve`` and ``step`` for each further iteration, then
        ``solve`` and ``post_solve``: the SVDs read the host, so the
        trainers' CUDA graphs capture the pieces between them. The tuple
        carries the iterations done, (transform, perm, beta, alpha) each,
        and the open one's (cov, finite, ca, cb, perm, beta, alpha)."""
        return self._iteration(xyz_src, xyz_ref, norm_ref, xyz_src, norm_src)

    @staticmethod
    def solve(state):
        """The open iteration's rotation in place of its (cov, finite)."""
        return (*state[:-7], kabsch_rotation(*state[-7:-5]), *state[-5:])

    @staticmethod
    def _close(solved):
        return (*solved[:-6], kabsch_transform(*solved[-6:-3]), *solved[-3:])

    def step(self, xyz_src, norm_src, xyz_ref, norm_ref, solved):
        """Close the solved iteration, then the next one up to its SVD,
        from the source moved by the closed transform, detached."""
        done = self._close(solved)
        xyz_src_t, norm_src_t = rt_transform_points_normals(done[-4].detach(), xyz_src,
                                                            norm_src)
        return (*done, *self._iteration(xyz_src, xyz_ref, norm_ref, xyz_src_t, norm_src_t))

    def post_solve(self, solved):
        """Close the last iteration -> (transforms, endpoints)."""
        done = self._close(solved)
        return list(done[0::4]), {"perm_matrices": list(done[1::4]), "beta": list(done[2::4]),
                                  "alpha": list(done[3::4])}

    def forward(self, xyz_src, norm_src, xyz_ref, norm_ref, num_iter: int = 2):
        """Returns (transforms, endpoints): a (B, 3, 4) transform per
        iteration, and ``perm_matrices``, ``beta`` and ``alpha`` per
        iteration. Iteration i + 1 starts from the source moved by iteration
        i's transform, detached."""
        if num_iter < 1:
            return [], {"perm_matrices": [], "beta": [], "alpha": []}
        state = self.pre_solve(xyz_src, norm_src, xyz_ref, norm_ref)
        for _ in range(num_iter - 1):
            state = self.step(xyz_src, norm_src, xyz_ref, norm_ref, self.solve(state))
        return self.post_solve(self.solve(state))
