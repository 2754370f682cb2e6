"""The plain reference of DCP-v2 (Wang and Solomon, "Deep Closest Point",
ICCV 2019; github.com/WangYueFt/dcp) trained without supervision by the
robust loss (the reference code's ``exps_deep_learning/dcp/Train_DCP.py``):
the network as a function of a dict of parameters, the loss, the gradient
by autograd and Adam on the flat concatenation of the parameters, skipped
on a non-finite loss or gradient.

The network, channels last (B, N, C): DGCNN (k = 20 nearest points by
squared distance, ties to the lower index; edge features [x_j, x_i]; four
pointwise layers each max-pooled over the neighbours, concatenated, a
fifth layer), each layer GroupNorm and ReLU (the published DGCNN has
BatchNorm: the port and its JAX original use GroupNorm, and so does this
reference); the transformer pointer (one encoder and one decoder layer of
the annotated transformer, pre-norm, LayerNorm with the unbiased deviation
and eps on it, 4 heads, no dropout; src' = Dec(src | Enc(tgt)) and tgt' =
Dec(tgt | Enc(src)), added to the embeddings); the SVD head (soft
correspondences by a softmax over the scaled embedding products, Kabsch by
SVD with the reflection fixed). Parameter names are the published
checkpoints'.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from portbench.reference import core as C

# (in, out, GroupNorm groups) of the DGCNN layers; layer 5 takes the four
# pooled outputs, 64 + 64 + 128 + 256 = 512 channels
DGCNN_LAYERS = ((6, 64, 8), (64, 64, 8), (64, 128, 8), (128, 256, 16), (512, None, 16))


def param_shapes(m: dict):
    """The parameters in the model's order, {name: shape}, and the names of
    the products (weight, bias) with their fan-in."""
    e, ff = m["emb_dims"], m["ff_dims"]
    shapes, fan_in = OrderedDict(), {}
    for i, (cin, cout, _) in enumerate(DGCNN_LAYERS, 1):
        cout = e if cout is None else cout
        shapes[f"emb_nn.conv{i}.weight"] = (cout, cin, 1, 1)
        fan_in[f"emb_nn.conv{i}.weight"] = cin
        shapes[f"emb_nn.bn{i}.weight"] = (cout,)
        shapes[f"emb_nn.bn{i}.bias"] = (cout,)

    def attn(pre):
        for j in range(4):
            shapes[f"{pre}.linears.{j}.weight"] = (e, e)
            shapes[f"{pre}.linears.{j}.bias"] = (e,)
            fan_in[f"{pre}.linears.{j}.weight"] = fan_in[f"{pre}.linears.{j}.bias"] = e

    def ffn(pre):
        for name, shape in (("w_1", (ff, e)), ("w_2", (e, ff))):
            shapes[f"{pre}.{name}.weight"] = shape
            shapes[f"{pre}.{name}.bias"] = (shape[0],)
            fan_in[f"{pre}.{name}.weight"] = fan_in[f"{pre}.{name}.bias"] = shape[1]

    def norm(pre):
        shapes[f"{pre}.a_2"] = (e,)
        shapes[f"{pre}.b_2"] = (e,)

    for part, subs in (("encoder", ("self_attn",)), ("decoder", ("self_attn", "src_attn"))):
        for b in range(m["n_blocks"]):
            pre = f"pointer.model.{part}.layers.{b}"
            for sub in subs:
                attn(f"{pre}.{sub}")
            ffn(f"{pre}.feed_forward")
            for s in range(len(subs) + 1):
                norm(f"{pre}.sublayer.{s}.norm")
        norm(f"pointer.model.{part}.norm")
    return shapes, fan_in


def init_weights(m: dict, seed: int, device):
    """Weights drawn from the seed on the device in one call: every product's
    weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the norms' scales 1
    and shifts 0. Returns the state dict (the parameters, then the SVD
    head's reflection buffer)."""
    shapes, fan_in = param_shapes(m)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    drawn = [k for k in shapes if k in fan_in]
    flat = torch.rand(sum(math.prod(shapes[k]) for k in drawn), generator=gen,
                      device=device) * 2 - 1
    out, o = OrderedDict(), 0
    for k, shape in shapes.items():
        if k in fan_in:
            n = math.prod(shape)
            out[k] = flat[o:o + n].reshape(shape) / math.sqrt(fan_in[k])
            o += n
        elif k.endswith(("bias", "b_2")):
            out[k] = torch.zeros(shape, device=device)
        else:
            out[k] = torch.ones(shape, device=device)
    out["head.reflect"] = torch.diag(torch.tensor([1.0, 1.0, -1.0], device=device))
    return out


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def group_norm(x, w, b, groups: int, eps: float = 1e-5):
    B, Cn = x.shape[0], x.shape[-1]
    g = x.reshape(B, -1, groups, Cn // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    mul = torch.rsqrt(var + eps) * w.reshape(groups, Cn // groups)
    y = (g - mean) * mul + b.reshape(groups, Cn // groups)
    return y.reshape(x.shape)


def layer_norm(x, a, b, eps: float = 1e-6):
    d = x.shape[-1]
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).sum(dim=-1, keepdim=True) / (d - 1)
    return a * (x - mean) / (torch.sqrt(var) + eps) + b


def knn_features(x, k: int):
    """Edge features (x_j, x_i) of each point's k nearest points (itself
    among them): (B, N, 3) -> (B, N, k, 6)."""
    B, N, Cn = x.shape
    d = -2 * C.mm(x, x.transpose(-1, -2))
    sq = (x ** 2).sum(dim=-1)
    d = -(d + sq[..., :, None] + sq[..., None, :])
    idx = torch.sort(d, dim=-1, descending=True, stable=True).indices[..., :k]
    off = torch.arange(B, device=x.device)[:, None, None] * N
    feat = x.reshape(B * N, Cn)[(idx + off).reshape(-1)].reshape(B, N, k, Cn)
    return torch.cat([feat, x[:, :, None, :].expand(B, N, k, Cn)], dim=-1)


def dgcnn(P, x, k: int):
    def layer(i, h):
        g = DGCNN_LAYERS[i - 1][2]
        h = C.linear(h, P[f"emb_nn.conv{i}.weight"].flatten(1))
        return torch.relu(group_norm(h, P[f"emb_nn.bn{i}.weight"], P[f"emb_nn.bn{i}.bias"], g))

    h, outs = knn_features(x, k), []
    for i in range(1, 5):
        h = layer(i, h)
        outs.append(h.amax(dim=2))
    return layer(5, torch.cat(outs, dim=-1))


def _scale(d_k: int) -> float:
    """sqrt(d_k) rounded to fp32."""
    return float(torch.tensor(float(d_k)).sqrt())


def attention(P, pre, q, k, v, heads: int):
    B = q.shape[0]
    d_k = q.shape[-1] // heads
    q, k, v = (C.linear(x, P[f"{pre}.linears.{j}.weight"], P[f"{pre}.linears.{j}.bias"])
               .reshape(B, x.shape[1], heads, d_k).transpose(1, 2)
               for j, x in enumerate((q, k, v)))
    scores = C.mm(q, k.transpose(-1, -2)) / _scale(d_k)
    out = C.mm(torch.softmax(scores, dim=-1), v)
    out = out.transpose(1, 2).reshape(B, -1, heads * d_k)
    return C.linear(out, P[f"{pre}.linears.3.weight"], P[f"{pre}.linears.3.bias"])


def feed_forward(P, pre, x):
    h = torch.relu(C.linear(x, P[f"{pre}.w_1.weight"], P[f"{pre}.w_1.bias"]))
    return C.linear(h, P[f"{pre}.w_2.weight"], P[f"{pre}.w_2.bias"])


def _norm(P, pre, x):
    return layer_norm(x, P[f"{pre}.a_2"], P[f"{pre}.b_2"])


def encoder(P, x, m):
    for b in range(m["n_blocks"]):
        pre = f"pointer.model.encoder.layers.{b}"
        y = _norm(P, f"{pre}.sublayer.0.norm", x)
        x = x + attention(P, f"{pre}.self_attn", y, y, y, m["n_heads"])
        x = x + feed_forward(P, f"{pre}.feed_forward", _norm(P, f"{pre}.sublayer.1.norm", x))
    return _norm(P, "pointer.model.encoder.norm", x)


def decoder(P, x, memory, m):
    for b in range(m["n_blocks"]):
        pre = f"pointer.model.decoder.layers.{b}"
        y = _norm(P, f"{pre}.sublayer.0.norm", x)
        x = x + attention(P, f"{pre}.self_attn", y, y, y, m["n_heads"])
        y = _norm(P, f"{pre}.sublayer.1.norm", x)
        x = x + attention(P, f"{pre}.src_attn", y, memory, memory, m["n_heads"])
        x = x + feed_forward(P, f"{pre}.feed_forward", _norm(P, f"{pre}.sublayer.2.norm", x))
    return _norm(P, "pointer.model.decoder.norm", x)


def svd_rotation(H):
    """R = V diag(1, 1, det) U^T of H = U S V^T; NaN where H is not finite."""
    finite = torch.isfinite(H).all(dim=-1).all(dim=-1)[..., None, None]
    U, _, Vh = torch.linalg.svd(torch.where(finite, H, torch.eye(3, dtype=H.dtype,
                                                                 device=H.device)))
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(C.mm(V, Ut))
    flip = torch.ones_like(V)
    flip[..., :, 2] = torch.where(det < 0, -1.0, 1.0)[..., None]
    return torch.where(finite, C.mm(V * flip, Ut), float("nan"))


def forward(P, src, tgt, m):
    """(R_ab, t_ab): the motion that takes src onto tgt, p' = R p + t."""
    src_emb, tgt_emb = dgcnn(P, src, m["dgcnn_k"]), dgcnn(P, tgt, m["dgcnn_k"])
    tgt_p = decoder(P, tgt_emb, encoder(P, src_emb, m), m)
    src_p = decoder(P, src_emb, encoder(P, tgt_emb, m), m)
    src_emb, tgt_emb = src_emb + src_p, tgt_emb + tgt_p
    scores = C.mm(src_emb, tgt_emb.transpose(-1, -2)) / _scale(src_emb.shape[-1])
    corr = C.mm(torch.softmax(scores, dim=2), tgt)
    src_mean, corr_mean = src.mean(dim=1), corr.mean(dim=1)
    H = C.mm((src - src_mean[:, None]).transpose(-1, -2), corr - corr_mean[:, None])
    R = svd_rotation(H)
    return R, -C.einsum("bij,bj->bi", R, src_mean) + corr_mean


def train_loss(P, batch, u4, m):
    """The robust loss of a batch: lines resampled against the boxes of the
    source as predicted and of the target, through a sphere of half the
    target box's diagonal; the per-sample metric / 5, summed, / B."""
    src, tar = batch["points_src_sample"], batch["points_tar_sample"]
    B = src.shape[0]
    R, t = forward(P, src, tar, m)
    pred = C.einsum("bij,bnj->bni", R, src) + t[:, None, :]
    box = batch["tar_box"]
    radius = 0.5 * torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
    lines = C.resample(u4, radius, batch["centers"], m["n_lines"], pred.detach(), tar)
    loss, valid = C.rigid_loss(R.transpose(-1, -2), t,
                               batch["points_based_neighs_src"].reshape(B, -1, 9),
                               batch["points_based_neighs_tar"].reshape(B, -1, 9), lines,
                               m["kmin"], m["kmax"])
    return (torch.where(valid, loss, 0.0) / 5.0).sum() / B


def epoch_seed(*parts: int) -> int:
    """A trainer's generator seed of (seed, epoch): numpy's SeedSequence."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1, np.uint64)[0])


def follow(weights, data, orders, m, fit_seed: int, device, loss_fn=train_loss):
    """The reference's first epochs, one a row of ``orders`` (epochs,
    n_batches, B) of rows of the dataset ``data`` (a dict of (n, ...)
    tensors on the device): for each batch, the uniforms of its epoch's
    generator, the loss, its gradient, and Adam at m["lr"] on the flat
    parameters, skipped on a non-finite value, its state carried from
    epoch to epoch. Returns per epoch (the mean loss, the flat parameters,
    the flat first moment), the parameters in ``param_shapes``'s order.
    ``loss_fn`` stands in for ``train_loss`` where a fault is planted."""
    names = list(param_shapes(m)[0])
    P = {k: weights[k].detach().clone().requires_grad_(k in names) for k in weights}
    params = [P[k] for k in names]
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    count = torch.zeros((), dtype=torch.int32, device=device)
    mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
    out = []
    for epoch, order in enumerate(orders):
        gen = torch.Generator(device=device)
        gen.manual_seed(epoch_seed(fit_seed, epoch))
        losses = []
        for row in order:
            idx = torch.as_tensor(row, device=device)
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
            u4 = torch.rand((len(row), 4, C.ROUNDS * m["n_lines"]), generator=gen,
                            device=device)
            loss = loss_fn(P, batch, u4, m)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            with torch.no_grad():
                g = torch.cat([(torch.zeros_like(p) if x is None else x).reshape(-1)
                               for x, p in zip(grads, params)])
                keep = torch.isfinite(loss) & torch.isfinite(g).all()
                flat, count, mu, nu = C.adam(m["lr"], g, count, mu, nu, flat, keep)
                torch._foreach_copy_(params, [x.view_as(y) for x, y in
                                              zip(flat.split([y.numel() for y in params]),
                                                  params)])
            losses.append(float(loss.detach()))
        out.append((float(np.mean(np.asarray(losses, np.float64))), flat, mu))
    return out


def leaf_norms(flat, m):
    """Per-parameter L2 norms of a flat vector in ``param_shapes``'s order."""
    shapes = param_shapes(m)[0]
    sizes = [math.prod(s) for s in shapes.values()]
    return {k: float(torch.linalg.vector_norm(x.double()))
            for k, x in zip(shapes, flat.detach().split(sizes))}
