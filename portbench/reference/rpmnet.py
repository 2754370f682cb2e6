"""The plain reference of RPM-Net (Yew and Lee, "RPM-Net: Robust Point
Matching using Learned Features", CVPR 2020; github.com/yewzijian/RPMNet)
trained without supervision by the robust loss (the reference code's
``exps_deep_learning/rpm/Train_RPM.py``): the network as a function of a
dict of parameters under the published names, the loss, the gradient by
autograd and Adam on the flat concatenation of the parameters at the
one-cycle schedule's rate, skipped on a non-finite loss or gradient.

An iteration, channels last (B, N, C):
- hybrid features of each cloud: a ball query (radius, ``num_neighbors``
  points by squared distance, the point itself left out, the first
  in-ball indices ascending, backfilled with the point itself), the
  neighbours' xyz and normals gathered, features xyz, dxyz and the PPF
  (three angles atan2(|v1 x v2|, v1 . v2) and the distance), three
  pointwise layers with GroupNorm and ReLU, the max over the neighbours,
  three more (the last a plain product), L2-normalised;
- beta and alpha: softplus of a PointNet over the union of both clouds,
  each point flagged 0 (source) or 1 (target), GroupNorm after every
  product but the last;
- the affinity -beta (|f_s - f_r|^2 - alpha), a log-domain Sinkhorn with a
  slack row and column (not normalised themselves), exp;
- the weighted Kabsch of ``compute_rigid_transform``: weights the rows'
  sums, normalised by their sum + 1e-5, the covariance of the centred
  clouds, R = V U^T with V's last column flipped where det <= 0.
Training runs two iterations, the source moved by the previous transform
detached; the loss is ``rpm_cal_loss`` (the robust metric of each
iteration's transform over lines drawn once against the source moved by
the first, the per-sample values summed and / the iteration count; the
outlier term (1 - the matrix's column and row sums) x ``wt_inliers``,
meaned; each discounted 0.5^(n - i - 1)) and ``rpm_total_loss``, 10 x
the outlier term + the metric.

Departures from the published code, each the port's:
- channels-last products (``F.linear``) for the 1x1 convolutions;
- the annealing net's last layer has the 2 outputs that are read, not
  2 + prod(weights_dim);
- the max over neighbours is ``amax`` (a tie shares its gradient; after
  the ReLU a tie is at 0, where none flows);
- a sample whose covariance is not finite gets the SVD of I and a NaN
  transform, where the published SVD would raise;
- the Kabsch translation and the rigid moves are ``einsum``s of R with the
  points, R p + t, as the port writes them (``se3.transform``'s p R^T + t
  in the published code).

Arithmetic is spelled out as the port's plain versions compute it, so
that on one device a sound program and this reference agree to the bit
and a change of precision shows (``core.py``); every matrix product goes
through ``core.mm``, ``core.linear`` or ``core.einsum`` for the control.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from portbench.reference import core as C
from portbench.reference import dcp as RD

# fp32 products, the configuration's precision, whatever imported this first
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-5  # the published rpmnet.py's _EPS
RAW = {"xyz": 3, "dxyz": 3, "ppf": 4}  # raw feature channels, concatenated in this order
# (in, out, GroupNorm groups) of the annealing net's pointwise layers and
# of its layers after the pool (the last a plain product)
ANNEAL_PRE = ((4, 64, 8), (64, 64, 8), (64, 64, 8), (64, 128, 8), (128, 1024, 16))
ANNEAL_POST = ((1024, 512, 16), (512, 256, 16), (256, 2, None))


def feature_layers(m: dict):
    """(in, out, groups) of the feature net before and after its pool."""
    d = m["feat_dim"]
    raw = sum(RAW[f] for f in m["features"])
    return ((raw, d, 8), (d, d, 8), (d, 2 * d, 8)), ((2 * d, 2 * d, 8), (2 * d, d, 8),
                                                     (d, d, None))


def param_shapes(m: dict):
    """The parameters in the model's order, {name: shape}, and the names of
    the products (weight, bias) with their fan-in."""
    shapes, fan_in = OrderedDict(), {}

    def stack(pre, layers, kernel):
        for i, (cin, cout, groups) in enumerate(layers):
            shapes[f"{pre}.{3 * i}.weight"] = (cout, cin) + kernel
            shapes[f"{pre}.{3 * i}.bias"] = (cout,)
            fan_in[f"{pre}.{3 * i}.weight"] = fan_in[f"{pre}.{3 * i}.bias"] = cin
            if groups is not None:
                shapes[f"{pre}.{3 * i + 1}.weight"] = (cout,)
                shapes[f"{pre}.{3 * i + 1}.bias"] = (cout,)

    pre, post = feature_layers(m)
    stack("weights_net.prepool", ANNEAL_PRE, (1,))
    stack("weights_net.postpool", ANNEAL_POST, ())
    stack("feat_extractor.prepool", pre, (1, 1))
    stack("feat_extractor.postpool", post, (1,))
    return shapes, fan_in


def init_weights(m: dict, seed: int, device):
    """Weights drawn from the seed on the device in one call: every
    product's weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
    norms' scales 1 and shifts 0."""
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
        else:
            out[k] = (torch.zeros if k.endswith("bias") else torch.ones)(shape, device=device)
    return out


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def layers(P, pre, x, specs):
    """Pointwise products with bias, each but a plain last one followed by
    GroupNorm and ReLU; the parameters of Sequential index 3i and 3i + 1."""
    for i, (_, _, groups) in enumerate(specs):
        x = C.linear(x, P[f"{pre}.{3 * i}.weight"].flatten(1), P[f"{pre}.{3 * i}.bias"])
        if groups is not None:
            x = torch.relu(RD.group_norm(x, P[f"{pre}.{3 * i + 1}.weight"],
                                         P[f"{pre}.{3 * i + 1}.bias"], groups))
    return x


def angle(v1, v2):
    """atan2(|v1 x v2|, v1 . v2) over the trailing axis."""
    cross = torch.linalg.cross(v1, v2, dim=-1)
    return torch.atan2(torch.linalg.vector_norm(cross, dim=-1), (v1 * v2).sum(-1))


def ball_query(radius: float, ns: int, xyz):
    """(B, N, ns) indices: each point's first ``ns`` others within
    ``radius`` (squared distance <= radius^2), ascending, the rest its
    own index."""
    B, N, _ = xyz.shape
    d = C.square_distance(xyz, xyz)
    rows = torch.arange(N, device=xyz.device).expand(B, N, N)
    itself = torch.arange(N, device=xyz.device).expand(B, N)[..., None]
    outside = (rows == itself) | (d > radius**2)
    idx = torch.sort(torch.where(outside, N, rows), dim=-1).values[..., :ns]
    return torch.where(idx == N, itself, idx)


def features(P, xyz, normals, m: dict):
    """Hybrid per-point features, L2-normalised: (B, N, 3) points and
    normals -> (B, N, feat_dim)."""
    B, N, _ = xyz.shape
    ns = m["num_neighbors"]
    idx = ball_query(m["radius"], ns, xyz)
    grouped = C.gather_rows(torch.cat([xyz, normals], dim=-1), idx.reshape(B, -1))
    grouped = grouped.reshape(B, N, ns, 6)
    d = grouped[..., :3] - xyz[:, :, None, :]
    ni, nr = grouped[..., 3:], normals[:, :, None, :]
    ppf = torch.stack([angle(nr, d), angle(ni, d), angle(nr.expand_as(ni), ni),
                       torch.linalg.vector_norm(d, dim=-1)], dim=-1)
    raw = {"xyz": xyz[:, :, None, :], "dxyz": d, "ppf": ppf}
    x = torch.cat([raw[f].expand(B, N, ns, RAW[f]) for f in RAW if f in m["features"]], dim=-1)
    pre, post = feature_layers(m)
    x = layers(P, "feat_extractor.postpool",
               layers(P, "feat_extractor.prepool", x, pre).amax(dim=2), post)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def anneal(P, src, ref):
    """(beta (B,), alpha (B,)) of the PointNet over both clouds, each point
    flagged 0 (source) or 1 (target)."""
    x = torch.cat([torch.nn.functional.pad(src, (0, 1), value=0.0),
                   torch.nn.functional.pad(ref, (0, 1), value=1.0)], dim=1)
    raw = layers(P, "weights_net.postpool",
                 layers(P, "weights_net.prepool", x, ANNEAL_PRE).amax(dim=1), ANNEAL_POST)
    return torch.nn.functional.softplus(raw[:, 0]), torch.nn.functional.softplus(raw[:, 1])


def sinkhorn(log_alpha, n_iters: int, slack: bool):
    """Log-domain Sinkhorn, rows then columns each iteration; with ``slack``
    on the matrix padded by a zero row and column that are not normalised."""
    if not slack:
        for _ in range(n_iters):
            log_alpha = log_alpha - torch.logsumexp(log_alpha, dim=2, keepdim=True)
            log_alpha = log_alpha - torch.logsumexp(log_alpha, dim=1, keepdim=True)
        return log_alpha
    padded = torch.nn.functional.pad(log_alpha, (0, 1, 0, 1))
    for _ in range(n_iters):
        rows = padded[:, :-1, :] - torch.logsumexp(padded[:, :-1, :], dim=2, keepdim=True)
        padded = torch.cat([rows, padded[:, -1:, :]], dim=1)
        cols = padded[:, :, :-1] - torch.logsumexp(padded[:, :, :-1], dim=1, keepdim=True)
        padded = torch.cat([cols, padded[:, :, -1:]], dim=2)
    return padded[:, :-1, :-1]


def rigid_transform(a, b, weights):
    """``compute_rigid_transform``: (B, 3, 4) [R | t] of the weighted
    alignment of a onto b (B, N, 3) with weights (B, N)."""
    w = weights[..., None] / (weights[..., None].sum(dim=1, keepdim=True) + EPS)
    ca, cb = (a * w).sum(dim=1), (b * w).sum(dim=1)
    cov = C.mm((a - ca[:, None, :]).transpose(-1, -2), (b - cb[:, None, :]) * w)
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)[:, None, None]
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    U, _, Vh = torch.linalg.svd(torch.where(finite, cov, eye))
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    R_pos = C.mm(V, Ut)
    R_neg = C.mm(torch.cat([V[..., :2], -V[..., 2:]], dim=-1), Ut)
    R = torch.where((torch.linalg.det(R_pos) > 0)[:, None, None], R_pos, R_neg)
    R = torch.where(finite, R, float("nan"))
    t = -C.einsum("bij,bj->bi", R, ca) + cb
    return torch.cat([R, t[..., None]], dim=-1)


def move(g, pts):
    """R p + t of (..., 3, 4) transforms on (..., N, 3) points (the loss's
    moved source)."""
    return C.einsum("...ij,...nj->...ni", g[..., :3, :3], pts) + g[..., :3, 3][..., None, :]


def forward(P, src, nsrc, ref, nref, m: dict, num_iter: int, detach: bool = True):
    """(transforms, endpoints): a (B, 3, 4) transform per iteration and
    the Sinkhorn matrices, beta and alpha of each; iteration i + 1 starts
    from the source and its normals moved by iteration i's transform,
    detached (``detach``)."""
    out = {"perm": [], "beta": [], "alpha": []}
    transforms, src_t, nsrc_t = [], src, nsrc
    for i in range(num_iter):
        beta, alpha = anneal(P, src_t, ref)
        dist = C.square_distance(features(P, src_t, nsrc_t, m), features(P, ref, nref, m))
        affinity = -beta[:, None, None] * (dist - alpha[:, None, None])
        perm = torch.exp(sinkhorn(affinity, m["num_sk_iter"], m["add_slack"]))
        weighted_ref = C.mm(perm, ref) / (perm.sum(dim=2, keepdim=True) + EPS)
        g = rigid_transform(src, weighted_ref, perm.sum(dim=2))
        transforms.append(g)
        for k, v in zip(out, (perm, beta, alpha)):
            out[k].append(v)
        if i < num_iter - 1:
            gd = g.detach() if detach else g
            src_t = C.einsum("bij,bnj->bni", gd[..., :3, :3], src) + gd[..., :3, 3][:, None, :]
            nsrc_t = C.einsum("bij,bnj->bni", gd[..., :3, :3], nsrc)
    return transforms, out


# ---------------------------------------------------------------------------
# the loss and the training
# ---------------------------------------------------------------------------

def cal_loss(transforms, perms, batch, u4, m: dict):
    """``rpm_cal_loss``'s optimised parts: (loss_intersection, loss_reg).
    The lines, n_lines a pair, are resampled once through the sphere of the
    target box's whole diagonal, against the boxes of the source moved by
    the first transform and of the target."""
    src, tar = batch["points_src_sample"], batch["points_tar_sample"]
    B, n = src.shape[0], len(transforms)
    with torch.no_grad():
        pred = move(transforms[0], src)
    box = batch["tar_box"]
    radius = 1.0 * torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
    lines = C.resample(u4, radius, batch["centers"], m["n_lines"], pred, tar)
    neis1 = batch["points_based_neighs_src"].reshape(B, -1, 9)
    neis2 = batch["points_based_neighs_tar"].reshape(B, -1, 9)
    inter = []
    for g in transforms:
        loss, valid = C.rigid_loss(g[..., :3, :3].transpose(-1, -2), g[..., :3, 3], neis1, neis2,
                                   lines, m["kmin"], m["kmax"])
        inter.append(torch.where(valid, loss, 0.0).sum() / n)
    reg = [((1.0 - p.sum(dim=1)) * m["wt_inliers"]).mean()
           + ((1.0 - p.sum(dim=2)) * m["wt_inliers"]).mean() for p in perms]

    def discounted(terms):
        return sum(t * m["discount"] ** (n - i - 1) for i, t in enumerate(terms))

    return discounted(inter), discounted(reg)


def train_loss(P, batch, u4, m: dict, detach: bool = True):
    """``rpm_total_loss`` of a batch at the training iterations: 10 x the
    outlier term + the robust metric."""
    transforms, out = forward(P, batch["points_src_sample"], batch["normals_src"],
                              batch["points_tar_sample"], batch["normals_tar"], m,
                              m["num_train_reg_iter"], detach)
    inter, reg = cal_loss(transforms, out["perm"], batch, u4, m)
    return 10.0 * reg + 1.0 * inter


def one_cycle_lr(m: dict, count):
    """The one-cycle schedule's rate at the optimiser's count (a 0-d int
    tensor), as fp32 arithmetic rounds it: from max_lr / div_factor up to
    max_lr by cosine over the first pct_start of onecycle_epochs, down to
    max_lr / (div_factor * final_div_factor) by cosine, then constant."""
    T = m["onecycle_epochs"]
    bounds = [0, int(m["pct_start"] * T), T]
    values = np.cumprod([m["max_lr"] / m["div_factor"], m["div_factor"],
                         1.0 / (m["div_factor"] * m["final_div_factor"])])
    lr = (count >= T).float() * float(values[-1])
    for i in range(2):
        start, end = float(values[i]), float(values[i + 1])
        pct = (count - bounds[i]).float() / (bounds[i + 1] - bounds[i])
        cos = end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1)
        lr = lr + ((bounds[i] <= count) & (count < bounds[i + 1])) * cos
    return lr


def follow(weights, data, orders, m: dict, fit_seed: int, device, loss_fn=train_loss):
    """The reference's first epochs, one a row of ``orders`` (epochs,
    n_batches, B) of rows of the dataset ``data`` (a dict of (n, ...)
    tensors on the device): for each batch, the uniforms of its epoch's
    generator, the loss, its gradient, and Adam at the schedule's rate on
    the flat parameters, skipped (the schedule's count too) on a
    non-finite value. Returns per epoch (the mean loss, the flat
    parameters, the flat first moment) in ``param_shapes``'s order.
    ``loss_fn`` stands in for ``train_loss`` where a fault is planted."""
    names = list(param_shapes(m)[0])
    P = {k: weights[k].detach().clone().requires_grad_() for k in names}
    params = [P[k] for k in names]
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    count = torch.zeros((), dtype=torch.int32, device=device)
    sched = torch.zeros_like(count)
    mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
    out = []
    for epoch, order in enumerate(orders):
        gen = torch.Generator(device=device)
        gen.manual_seed(RD.epoch_seed(fit_seed, epoch))
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
                flat, count, mu, nu = C.adam(one_cycle_lr(m, sched), g, count, mu, nu, flat,
                                             keep)
                sched = torch.where(keep, sched + 1, sched)
                torch._foreach_copy_(params, [x.view_as(y) for x, y in
                                              zip(flat.split([y.numel() for y in params]),
                                                  params)])
            losses.append(float(loss.detach()))
        out.append((float(np.mean(np.asarray(losses, np.float64))), flat, mu))
    return out


def leaf_norms(flat, m: dict):
    """Per-parameter L2 norms of a flat vector in ``param_shapes``'s order."""
    shapes = param_shapes(m)[0]
    sizes = [math.prod(s) for s in shapes.values()]
    return {k: float(torch.linalg.vector_norm(x.double()))
            for k, x in zip(shapes, flat.detach().split(sizes))}
