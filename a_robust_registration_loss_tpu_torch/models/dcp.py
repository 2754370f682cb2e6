"""DCP (Deep Closest Point) as ``nn.Module``s, channels-last.

Port of ``a_robust_registration_loss_tpu/models/dcp.py``: point clouds and
features are (B, N, C) as there, pointwise convolutions are linear maps over
the trailing axis, and the SVD head solves all samples in one batched SVD.

- PointNet embedding: 5 pointwise layers 3-64-64-64-128-emb with
  GroupNorm(8/16) + ReLU.
- DGCNN embedding: kNN (k = 20) edge features of the raw points, 4 stages
  each max-pooled over the neighbours, concatenated, and a final layer.
- Transformer pointer: the "annotated transformer" encoder / decoder with
  the reference's LayerNorm and no dropout, cross-attending both ways and
  added residually. The identity pointer returns its inputs, so the residual
  add doubles the embedding (a quirk of the reference, kept).
- Heads: SVD (soft correspondences + Kabsch) and MLP (quaternion).

forward(src, tgt) -> (R_ab, t_ab, R_ba, t_ba), with ba the inverse of ab
unless ``cycle``.

Parameter names and shapes are those of the reference PyTorch DCP
(``emb_nn.conv1.weight`` of shape (64, 3, 1), ``pointer.model.encoder.
layers.0.self_attn.linears.0.weight``, ``head.nn.0.weight``, ...), so a
reference checkpoint is a plain ``load_state_dict``;
``models/transplant.py:dcp_from_flax`` brings the JAX package's parameter
tree into the same names.

The attention and the other large products are ``torch.matmul`` and
``torch.softmax`` in fp32, as they are plain XLA products in the JAX
package; the graph gather is plain indexing, as it is ``jnp.take`` there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch
import torch.nn.functional as F
from torch import nn

from a_robust_registration_loss_tpu_torch.models.common import (
    TorchGroupNorm,
    TorchLayerNorm,
    quat2mat,
    svd_orientation,
)


@dataclasses.dataclass(frozen=True)
class DCPConfig:
    """Mirrors the reference CLI flags. fp32 only."""

    emb_nn: Literal["pointnet", "dgcnn"] = "dgcnn"
    pointer: Literal["identity", "transformer"] = "transformer"
    head: Literal["mlp", "svd"] = "svd"
    emb_dims: int = 512
    n_blocks: int = 1
    n_heads: int = 4
    ff_dims: int = 1024
    dgcnn_k: int = 20
    cycle: bool = False


class Pointwise(nn.Module):
    """A bias-free 1x1 convolution on channels-last features: a linear map
    over the trailing axis whose ``weight`` keeps the convolution's shape
    (out, in, 1) or (out, in, 1, 1), the reference checkpoints' own."""

    def __init__(self, in_channels: int, out_channels: int, kernel_dims: int):
        super().__init__()
        w = torch.empty((out_channels, in_channels) + (1,) * kernel_dims)
        nn.init.kaiming_uniform_(w, a=math.sqrt(5))
        self.weight = nn.Parameter(w)

    def forward(self, x):
        return F.linear(x, self.weight.flatten(1))


class _ConvStack(nn.Module):
    """conv1..conv5 and bn1..bn5 of an embedding net."""

    def __init__(self, layers, kernel_dims: int):
        super().__init__()
        for i, (cin, cout, groups) in enumerate(layers, start=1):
            setattr(self, f"conv{i}", Pointwise(cin, cout, kernel_dims))
            setattr(self, f"bn{i}", TorchGroupNorm(groups, cout))

    def layer(self, i: int, x):
        return F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))


class PointNetEmb(_ConvStack):
    def __init__(self, emb_dims: int = 512):
        super().__init__([(3, 64, 8), (64, 64, 8), (64, 64, 8), (64, 128, 16),
                          (128, emb_dims, 16)], kernel_dims=1)

    def forward(self, x):  # (B, N, 3) -> (B, N, emb)
        for i in range(1, 6):
            x = self.layer(i, x)
        return x


def knn_graph_indices(x, k: int):
    """(B, N, C) -> (B, N, k) int64: each point's k nearest points (itself
    among them) by squared distance, ties by the lower index, which is the
    order ``lax.top_k`` gives on the negated distances."""
    d = -2 * (x @ x.transpose(-1, -2))
    sq = (x**2).sum(dim=-1)
    d = -(d + sq[..., :, None] + sq[..., None, :])  # negative squared distance
    return torch.sort(d, dim=-1, descending=True, stable=True).indices[..., :k]


def knn_graph_feature(x, k: int):
    """Edge features (neighbour, x_i): the reference concatenates the
    neighbour's feature itself, not the DGCNN paper's (x_j - x_i).
    x: (B, N, C) -> (B, N, k, 2C)."""
    B, N, C = x.shape
    idx = knn_graph_indices(x, k)
    off = torch.arange(B, device=x.device)[:, None, None] * N
    feat = x.reshape(B * N, C)[(idx + off).reshape(-1)].reshape(B, N, k, C)
    xi = x[:, :, None, :].expand(B, N, k, C)
    return torch.cat([feat, xi], dim=-1)


class DGCNNEmb(_ConvStack):
    def __init__(self, emb_dims: int = 512, k: int = 20):
        super().__init__([(6, 64, 8), (64, 64, 8), (64, 128, 8), (128, 256, 16),
                          (512, emb_dims, 16)], kernel_dims=2)
        self.k = k

    def forward(self, x):  # (B, N, 3) -> (B, N, emb)
        return self.embed_graph(knn_graph_feature(x, self.k))

    def embed_graph(self, h):  # edge features (B, N, k, 6) -> (B, N, emb)
        outs = []
        for i in range(1, 5):
            h = self.layer(i, h)
            outs.append(h.amax(dim=2))  # max over the k neighbours
        return self.layer(5, torch.cat(outs, dim=-1))


class MultiHeadAttention(nn.Module):
    """``linears``: the query, key, value and output projections."""

    def __init__(self, n_heads: int, d_model: int):
        super().__init__()
        self.n_heads = n_heads
        self.d_k = d_model // n_heads
        self.linears = nn.ModuleList([nn.Linear(d_model, d_model) for _ in range(4)])

    def forward(self, q, k, v):
        B = q.shape[0]
        q, k, v = (lin(x).reshape(B, x.shape[1], self.n_heads, self.d_k).transpose(1, 2)
                   for lin, x in zip(self.linears, (q, k, v)))
        scores = q @ k.transpose(-1, -2) / math.sqrt(self.d_k)
        out = torch.softmax(scores, dim=-1) @ v
        out = out.transpose(1, 2).reshape(B, -1, self.n_heads * self.d_k)
        return self.linears[3](out)


class FeedForward(nn.Module):
    """Position-wise FFN: ``w_1`` is the inner d_ff expansion (``Dense_1``
    of the JAX package) and ``w_2`` the outer projection (``Dense_0``)."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w_1 = nn.Linear(d_model, d_ff)
        self.w_2 = nn.Linear(d_ff, d_model)

    def forward(self, x):
        return self.w_2(F.relu(self.w_1(x)))


class _Sublayer(nn.Module):
    """The pre-norm of a residual branch (``sublayer.i.norm``)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.norm = TorchLayerNorm(d_model)


def _sublayers(n: int, d_model: int):
    return nn.ModuleList([_Sublayer(d_model) for _ in range(n)])


class EncoderLayer(nn.Module):
    def __init__(self, cfg: DCPConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg.n_heads, cfg.emb_dims)
        self.feed_forward = FeedForward(cfg.emb_dims, cfg.ff_dims)
        self.sublayer = _sublayers(2, cfg.emb_dims)

    def forward(self, x):
        y = self.sublayer[0].norm(x)
        x = x + self.self_attn(y, y, y)
        return x + self.feed_forward(self.sublayer[1].norm(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DCPConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg.n_heads, cfg.emb_dims)
        self.src_attn = MultiHeadAttention(cfg.n_heads, cfg.emb_dims)
        self.feed_forward = FeedForward(cfg.emb_dims, cfg.ff_dims)
        self.sublayer = _sublayers(3, cfg.emb_dims)

    def forward(self, x, memory):
        y = self.sublayer[0].norm(x)
        x = x + self.self_attn(y, y, y)
        y = self.sublayer[1].norm(x)
        x = x + self.src_attn(y, memory, memory)
        return x + self.feed_forward(self.sublayer[2].norm(x))


class _Stack(nn.Module):
    """``layers`` and the closing ``norm`` of an encoder or a decoder."""

    def __init__(self, layer_cls, cfg: DCPConfig):
        super().__init__()
        self.layers = nn.ModuleList([layer_cls(cfg) for _ in range(cfg.n_blocks)])
        self.norm = TorchLayerNorm(cfg.emb_dims)

    def forward(self, x, *memory):
        for layer in self.layers:
            x = layer(x, *memory)
        return self.norm(x)


class _EncoderDecoder(nn.Module):
    def __init__(self, cfg: DCPConfig):
        super().__init__()
        self.encoder = _Stack(EncoderLayer, cfg)
        self.decoder = _Stack(DecoderLayer, cfg)


class TransformerPointer(nn.Module):
    """Cross-directional pointer: src' = Dec(src | Enc(tgt)), tgt' =
    Dec(tgt | Enc(src)). The stacks sit under ``model``."""

    def __init__(self, cfg: DCPConfig):
        super().__init__()
        self.model = _EncoderDecoder(cfg)

    def forward(self, src_emb, tgt_emb):
        enc, dec = self.model.encoder, self.model.decoder
        tgt_p = dec(tgt_emb, enc(src_emb))
        src_p = dec(src_emb, enc(tgt_emb))
        return src_p, tgt_p


class SVDHead(nn.Module):
    """Soft correspondences + differentiable Kabsch."""

    def __init__(self, cfg: DCPConfig):
        super().__init__()
        # the reference keeps diag(1, 1, -1) in its state dict; the flip is
        # done by svd_orientation, the buffer keeps the checkpoints loadable
        self.register_buffer("reflect", torch.diag(torch.tensor([1.0, 1.0, -1.0])))

    def correlation(self, src_emb, tgt_emb, src, tgt):
        """(H (B, 3, 3), src_mean, corr_mean): the cross-covariance of the
        source and its soft correspondences, which the SVD takes. The
        gradient through the SVD needs H's singular values apart."""
        d_k = src_emb.shape[-1]
        scores = src_emb @ tgt_emb.transpose(-1, -2) / math.sqrt(d_k)
        scores = torch.softmax(scores, dim=2)  # over the target points
        src_corr = scores @ tgt  # (B, N, 3)
        src_mean, corr_mean = src.mean(dim=1), src_corr.mean(dim=1)
        src_c = src - src_mean[:, None]
        corr_c = src_corr - corr_mean[:, None]
        return src_c.transpose(-1, -2) @ corr_c, src_mean, corr_mean

    def forward(self, src_emb, tgt_emb, src, tgt):
        H, src_mean, corr_mean = self.correlation(src_emb, tgt_emb, src, tgt)
        R = svd_orientation(H)
        t = -torch.einsum("bij,bj->bi", R, src_mean) + corr_mean
        return R, t


class MLPHead(nn.Module):
    """Global-pool quaternion head."""

    def __init__(self, cfg: DCPConfig):
        super().__init__()
        d = cfg.emb_dims
        layers, width = [], 2 * d
        for out in (d // 2, d // 4, d // 8):
            layers += [nn.Linear(width, out), TorchGroupNorm(8, out), nn.ReLU()]
            width = out
        self.nn = nn.Sequential(*layers)
        self.proj_rot = nn.Linear(width, 4)
        self.proj_trans = nn.Linear(width, 3)

    def forward(self, src_emb, tgt_emb, src, tgt):
        e = self.nn(torch.cat([src_emb, tgt_emb], dim=-1).amax(dim=1))  # (B, d/8)
        quat = self.proj_rot(e)
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        return quat2mat(quat), self.proj_trans(e)


class DCP(nn.Module):
    """forward(src, tgt) on channels-last (B, N, 3) point clouds."""

    def __init__(self, cfg: DCPConfig = DCPConfig()):
        super().__init__()
        self.cfg = cfg
        if cfg.emb_nn == "pointnet":
            self.emb_nn = PointNetEmb(cfg.emb_dims)
        else:
            self.emb_nn = DGCNNEmb(cfg.emb_dims, cfg.dgcnn_k)
        self.pointer = TransformerPointer(cfg) if cfg.pointer == "transformer" else None
        self.head = SVDHead(cfg) if cfg.head == "svd" else MLPHead(cfg)

    def forward(self, src, tgt):
        src_emb = self.emb_nn(src)
        tgt_emb = self.emb_nn(tgt)
        if self.pointer is not None:
            src_p, tgt_p = self.pointer(src_emb, tgt_emb)
        else:
            src_p, tgt_p = src_emb, tgt_emb  # identity: the residual doubles
        src_emb = src_emb + src_p
        tgt_emb = tgt_emb + tgt_p
        R_ab, t_ab = self.head(src_emb, tgt_emb, src, tgt)
        if self.cfg.cycle:
            R_ba, t_ba = self.head(tgt_emb, src_emb, tgt, src)
        else:
            R_ba = R_ab.transpose(-1, -2)
            t_ba = -torch.einsum("bij,bj->bi", R_ba, t_ab)
        return R_ab, t_ab, R_ba, t_ba


def reset_parameters(model: nn.Module, generator: torch.Generator):
    """Redraw every weight and bias of ``model`` from ``generator`` (a CPU
    generator; call before moving the model): U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), the default of ``nn.Linear``. The norms keep their ones
    and zeros."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, Pointwise)):
                bound = 1.0 / math.sqrt(module.weight.shape[1])
                for p in module.parameters(recurse=False):
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
