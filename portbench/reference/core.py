"""The plain reference of the robust intersected-line metric and what it
stands on, written out in plain PyTorch: farthest-point sampling, k-NN
neighbourhoods, the axis-aligned box meshes, the rejection resampler of
lines, stage 1 (which neighbourhoods a line passes through), stage 2 (the
robust Welsch loss over the slot points), the SE(3) exponential and Adam.

It follows the method's published description (Deng et al., "A robust
loss for point cloud registration", the reference code's ``loss.py`` and
``test_demo_optimized_Lie_Algebra.py``) and is independent of the program:
it imports nothing of it. Where a label sits on a rounding knife edge (a
barycentric area sum, a distance threshold, an argmax of distances) it
spells each rounding out as one operation, so that a sound program and
this reference agree to the bit on the same device, and a change of
precision shows.

``CONTROL`` selects the control of the comparison that decides ``correct``:
with it set, every matrix product rounds its operands to TF32 (10 bits of
mantissa) before multiplying in fp32, which is what the tensor cores do
with TF32 enabled. The program states fp32 with TF32 off.
"""

from __future__ import annotations

import math

import torch

CONTROL = {"tf32": False}  # set by a control run, never by a benchmark run

ROUNDS = 10      # candidates drawn per kept line
NF = 12          # triangles of a box mesh
NNEI = 3         # points of a neighbourhood


# ---------------------------------------------------------------------------
# arithmetic helpers
# ---------------------------------------------------------------------------

def _round_tf32(x):
    """x rounded to TF32's 10-bit mantissa, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32(torch.autograd.Function):
    """The rounding as an operand of a product; its gradient, an operand of
    the backward's products, is rounded alike."""

    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def tf32(x):
    return _TF32.apply(x)


def mm(a, b):
    """a @ b in fp32, or with TF32 operands under ``CONTROL``."""
    if CONTROL["tf32"]:
        return tf32(a) @ tf32(b)
    return a @ b


def einsum(eq, a, b):
    """A two-operand einsum, with TF32 operands under ``CONTROL``."""
    if CONTROL["tf32"]:
        a, b = tf32(a), tf32(b)
    return torch.einsum(eq, a, b)


def linear(x, w, b=None):
    """x @ w^T (+ b), one fused product as ``nn.Linear`` computes it; with
    TF32 operands under ``CONTROL``."""
    if CONTROL["tf32"]:
        x, w = tf32(x), tf32(w)
    return torch.nn.functional.linear(x, w, b)


def sqrt_rn(x):
    """The correctly rounded fp32 square root: CUDA's is; the CPU's
    vectorised one may be an ulp off, so there it goes through float64."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def norm3(v):
    return sqrt_rn(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def square_distance(a, b):
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances by the
    inner-product expansion."""
    d = -2.0 * mm(a, b.transpose(-1, -2))
    d = d + (a ** 2).sum(-1)[..., :, None]
    return d + (b ** 2).sum(-1)[..., None, :]


def farthest_points(xyz, npoint: int):
    """Greedy farthest-point sampling from index 0, batched: (B, N, 3) ->
    (B, npoint) indices; the first argmax wins a tie."""
    B, N, _ = xyz.shape
    far = torch.zeros(B, dtype=torch.long, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.long, device=xyz.device)
    dist = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        d = ((xyz - xyz[rows, far][:, None, :]) ** 2).sum(-1)
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)
    return out


def gather_rows(points, idx):
    """points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B = points.shape[0]
    flat = idx.reshape(B, -1)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(idx.shape + (points.shape[-1],))


def neighbourhoods(points, num_sample: int, k: int = NNEI):
    """FPS seeds and each seed's k nearest points (itself first, ties to the
    lower index): (B, N, 3) -> (B, n * k, 3), n = min(num_sample, N)."""
    n = min(num_sample, points.shape[1])
    seeds = gather_rows(points, farthest_points(points, n))
    d = square_distance(seeds, points)
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return gather_rows(points, idx.reshape(points.shape[0], -1)).reshape(points.shape[0], n * k, 3)


def chamfer(x, y):
    """The mean of both directions' nearest squared distances over the whole
    batch, (B, M, 3) x (B, N, 3) -> ()."""
    d = square_distance(x, y)
    return torch.cat([d.amin(dim=2).reshape(-1), d.amin(dim=1).reshape(-1)]).mean()


# corner c = 4a + 2b + c' takes x, y, z from the max (bit 0) or the min (1)
_CORNER_BITS = [[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)]
BOX_FACES = [[2, 0, 6], [0, 4, 6], [5, 4, 0], [5, 0, 1], [6, 4, 5], [5, 7, 6],
             [3, 0, 2], [1, 0, 3], [3, 2, 6], [6, 7, 3], [5, 1, 3], [3, 7, 5]]


def box_corners(v):
    """(B, N, 3) -> (B, 8, 3): corner 0 the max, corner 7 the min."""
    bits = torch.tensor(_CORNER_BITS, dtype=torch.bool, device=v.device)
    return torch.where(bits, v.amin(dim=1)[:, None, :], v.amax(dim=1)[:, None, :])


def box_faces(v):
    """The 12 triangles of each cloud's box: (B, N, 3) -> (B, 12, 9)."""
    faces = torch.tensor(BOX_FACES, dtype=torch.long, device=v.device).reshape(-1)
    return box_corners(v)[:, faces].reshape(v.shape[0], NF, 9)


# ---------------------------------------------------------------------------
# the line resampler
# ---------------------------------------------------------------------------

def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def sphere_points(ua, uu, r):
    """Uniform points on the radius-r sphere from two uniforms each; cos and
    sin of the azimuth correctly rounded (taken in float64)."""
    alpha = (ua * 2.0 * math.pi).double()
    u = uu * 2.0 - 1.0
    s = sqrt_rn(torch.clamp_min(1.0 - u * u, 0.0))
    cos, sin = torch.cos(alpha).to(u.dtype), torch.sin(alpha).to(u.dtype)
    r = r[..., None]
    return torch.stack([r * (s * cos), r * (s * sin), r * u], dim=-1)


def candidates(u4, r, center):
    """(B, 4, C) uniforms -> (B, C, 6) lines [direction | point]: two sphere
    points, the direction their normalised difference."""
    q1 = sphere_points(u4[:, 0], u4[:, 1], r)
    q2 = sphere_points(u4[:, 2], u4[:, 3], r)
    d = q2 - q1
    d = d / torch.clamp_min(norm3(d), 1e-12)[..., None]
    return torch.cat([d, q1 + center[:, None, :]], dim=-1)


def _prep(faces):
    """(B, F, 9) triangles -> their corners, unit normal and parallelogram
    area, each as (B, F) tensors."""
    p0 = [faces[..., c] for c in range(3)]
    p1 = [faces[..., 3 + c] for c in range(3)]
    p2 = [faces[..., 6 + c] for c in range(3)]
    n = _cross([p1[c] - p0[c] for c in range(3)], [p2[c] - p0[c] for c in range(3)])
    S = sqrt_rn(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    inv = 1.0 / torch.clamp_min(S, 1e-12)
    return p0, p1, p2, [n[c] * inv for c in range(3)], S


def _area(u, v):
    w = _cross(u, v)
    return sqrt_rn(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])


def triangle_hit(tri, f, lines):
    """Whether each line (B, C, 6) passes through triangle f of the
    prepared triangles ``tri``: the barycentric areas of the plane
    crossing, A > 0, B > 0, C > 0 and A + B + C <= S."""
    p0, p1, p2, nh, S = ([x[..., f, None] for x in part] if isinstance(part, list)
                         else part[..., f, None] for part in tri)
    d = [lines[..., c] for c in range(3)]
    o = [lines[..., 3 + c] for c in range(3)]
    denom = nh[0] * d[0] + nh[1] * d[1] + nh[2] * d[2] + 1e-12
    tnum = nh[0] * (p0[0] - o[0]) + nh[1] * (p0[1] - o[1]) + nh[2] * (p0[2] - o[2])
    t = tnum / denom
    x = [t * d[c] + o[c] for c in range(3)]
    a = [x[c] - p0[c] for c in range(3)]
    b = [x[c] - p1[c] for c in range(3)]
    c_ = [x[c] - p2[c] for c in range(3)]
    bA, bB, bC = _area(b, c_), _area(c_, a), _area(a, b)
    return (bA > 0) & (bB > 0) & (bC > 0) & (bA + bB + bC <= S)


def mesh_hit(faces, lines):
    """Any-hit of lines (B, C, 6) against triangles (B, F, 9)."""
    tri = _prep(faces)
    hit = None
    for f in range(faces.shape[-2]):
        h = triangle_hit(tri, f, lines)
        hit = h if hit is None else hit | h
    return hit


def accepted(u4, r, center, verts1, verts2):
    """(candidates (B, C, 6), accepted (B, C), hits of mesh 2 (B, C)): a
    candidate is accepted where it passes through both clouds' boxes."""
    cand = candidates(u4, r, center)
    hit2 = mesh_hit(box_faces(verts2), cand)
    return cand, mesh_hit(box_faces(verts1), cand) & hit2, hit2


def resample(u4, r, center, n: int, verts1, verts2):
    """The first n accepted candidates of each sample, in draw order, the
    tail zero-filled: u4 (B, 4, ROUNDS * n), r (B,), center (B, 3),
    verts (B, N, 3) -> (B, n, 6)."""
    cand, ok, _ = accepted(u4, r, center, verts1, verts2)
    pos = torch.cumsum(ok, dim=-1) - 1
    dest = torch.where(ok & (pos < n), pos, n)
    out = torch.zeros((cand.shape[0], n + 1, 6), dtype=cand.dtype, device=cand.device)
    out.scatter_(1, dest[..., None].expand_as(cand), cand)
    return out[:, :n]


# ---------------------------------------------------------------------------
# the metric
# ---------------------------------------------------------------------------

def spacing(neis):
    """Mean pairwise spacing of each 3-point neighbourhood (B, F, 9) -> (B, F)."""
    p0, p1, p2 = neis[..., 0:3], neis[..., 3:6], neis[..., 6:9]
    return (norm3(p1 - p0) + norm3(p2 - p0) + norm3(p1 - p2)) / 3.0


def _d2(P, lines):
    """Squared point-line distances of points P (B, L, ..., 3) against their
    lines (B, L, 6) broadcast over the middle axes."""
    extra = P.dim() - 3
    ln = lines.reshape(lines.shape[:2] + (1,) * extra + (6,))
    diff = [P[..., c] - ln[..., 3 + c] for c in range(3)]
    d_ac = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    proj = diff[0] * ln[..., 0] + diff[1] * ln[..., 1] + diff[2] * ln[..., 2]
    return d_ac - proj * proj


def first_hits(neis, lines, kmax: int, chunk: int = 2048):
    """Stage 1: a line passes through a neighbourhood when each of its
    points lies within (delta * 1.731 / 2)^2 - 2e-4 (squared) of the line.
    neis (B, F, 9), lines (B, L, 6) -> (count (B, L) int32, the first kmax
    neighbourhoods passed, ascending, (B, L, kmax) long, 0 where empty)."""
    B, F, _ = neis.shape
    thr2 = (spacing(neis) * (1.731 / 2.0)) ** 2 - 2e-4
    P = neis.reshape(B, 1, F, NNEI, 3)
    faces = torch.arange(F, device=neis.device)
    counts, slots = [], []
    for lo in range(0, lines.shape[1], chunk):
        ln = lines[:, lo:lo + chunk]
        n = ln.shape[1]
        hit = torch.ones((B, n, F), dtype=torch.bool, device=neis.device)
        for i in range(NNEI):
            hit &= _d2(P[..., i, :], ln) < thr2[:, None, :]
        rank = torch.cumsum(hit, dim=-1) - 1
        pos = torch.where(hit & (rank < kmax), rank, kmax)
        buf = torch.zeros((B, n, kmax + 1), dtype=torch.long, device=neis.device)
        buf.scatter_(2, pos, faces.expand(B, n, F))
        counts.append(hit.sum(-1, dtype=torch.int32))
        slots.append(buf[..., :kmax])
    return torch.cat(counts, 1), torch.cat(slots, 1)


def _filled(count, kmax: int):
    return torch.arange(kmax, device=count.device) < torch.clamp_max(count, kmax)[..., None]


def slot_reconstruction(neis, lines, kmax: int):
    """Stage 1 and the reconstruction of each filled slot: the
    distance-weighted sum of the neighbourhood's points, w_i = d_i / sum d,
    d_i = sqrt(max(d2_i + 2e-4, 0)). -> (recon (B, L, kmax, 3) with 0 on
    empty slots, count (B, L))."""
    B, F, _ = neis.shape
    count, idx = first_hits(neis, lines, kmax)
    filled = _filled(count, kmax)
    P = gather_rows(neis, idx.reshape(B, -1)).reshape(B, lines.shape[1], kmax, NNEI, 3)
    P = torch.where(filled[..., None, None], P, 0.0)
    d2 = _d2(P.reshape(B, lines.shape[1], kmax * NNEI, 3), lines)
    d2 = d2.reshape(B, lines.shape[1], kmax, NNEI)
    d = [sqrt_rn(torch.clamp_min(d2[..., i] + 2e-4, 0.0)) for i in range(NNEI)]
    dsum = d[0] + d[1] + d[2]
    w = [d[i] / dsum for i in range(NNEI)]
    rows = []
    for c in range(3):
        acc = w[0] * P[..., 0, c] + w[1] * P[..., 1, c] + w[2] * P[..., 2, c]
        rows.append(torch.where(filled, acc, 0.0))
    return torch.stack(rows, dim=-1), count


def welsch(x, c):
    return 1.0 - torch.exp(-(x / c) / 2.0)


def _lower_median(values, mask):
    """The (n - 1) // 2-th order statistic of each sample's masked values."""
    B = values.shape[0]
    flat = torch.where(mask, values, torch.inf).reshape(B, -1)
    srt = torch.sort(flat, dim=-1).values
    k = torch.clamp_min((mask.reshape(B, -1).sum(-1) - 1) // 2, 0)
    return srt.gather(-1, k[:, None])[:, 0]


def robust_loss(pts1, pts2, c1, c2, kmin: int, kmax: int):
    """Stage 2: per sample (loss, valid) from both clouds' slot points
    (B, L, kmax, 3) and counts (B, L). A line counts where both clouds are
    passed kmin to kmax times; each slot's nearest squared distance to the
    other cloud's slots goes through Welsch at the median of all such
    distances, normalised per (count1, count2) combination and weighted by
    exp(-|count1 - count2| / 2); the sum over lines is divided by the
    number of combinations that occur."""
    lvalid = (c1 >= kmin) & (c1 <= kmax) & (c2 >= kmin) & (c2 <= kmax)
    ok1 = _filled(c1, kmax) & lvalid[..., None]
    ok2 = _filled(c2, kmax) & lvalid[..., None]
    diff = [pts1[..., :, None, c] - pts2[..., None, :, c] for c in range(3)]
    D = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    median = _lower_median(D.detach(), ok1[..., :, None] & ok2[..., None, :])[:, None, None]
    rowmin = torch.where(ok2[..., None, :], D, torch.inf).amin(dim=-1)
    colmin = torch.where(ok1[..., :, None], D, torch.inf).amin(dim=-2)
    nC = kmax - kmin + 1
    cid = torch.where(lvalid, (c1 - kmin) * nC + (c2 - kmin), nC * nC).long()
    n_combo = torch.zeros((c1.shape[0], nC * nC + 1), dtype=torch.int32, device=c1.device)
    n_combo.scatter_add_(-1, cid, torch.ones_like(cid, dtype=torch.int32))
    n_nonempty = (n_combo[:, :nC * nC] > 0).sum(-1)
    n_line = torch.where(lvalid, n_combo.gather(-1, cid), 1)
    row_w = torch.where(ok1, welsch(rowmin, median), 0.0)
    col_w = torch.where(ok2, welsch(colmin, median), 0.0)
    row_sum, col_sum = row_w[..., 0], col_w[..., 0]
    for s in range(1, kmax):
        row_sum = row_sum + row_w[..., s]
        col_sum = col_sum + col_w[..., s]
    row_term = row_sum / (n_line * torch.clamp_min(c1, 1).float())
    col_term = col_sum / (n_line * torch.clamp_min(c2, 1).float())
    w_line = torch.exp(-0.5 * (c1 - c2).abs().float())
    per_line = torch.where(lvalid, w_line * (row_term + col_term), 0.0)
    return per_line.sum(-1) / torch.clamp_min(n_nonempty, 1).float(), n_nonempty > 0


def rigid_loss(R, t, neis1, neis2, lines, kmin: int, kmax: int):
    """The metric of cloud 1 moved by p @ R + t against cloud 2: R (B, 3, 3),
    t (B, 3), neis (B, F, 9), lines (B, L, 6) -> (loss (B,), valid (B,));
    or one sample without the batch axis, its results then of shape (1,).
    Stage 1 runs on the moved cloud without a gradient; the gradient reaches
    (R, t) through the slot points, moved back to the raw cloud with the
    detached (R, t) and forward again with the traced ones."""
    with torch.no_grad():
        if R.dim() == 2:  # one sample, as (F, 9) / (L, 6) without a batch axis
            moved = (mm(neis1.reshape(-1, 3), R) + t).reshape(neis1.shape)[None]
            neis2, lines = neis2[None], lines[None]
        else:
            moved = (mm(neis1.reshape(R.shape[0], -1, 3), R)
                     + t[:, None, :]).reshape(neis1.shape)
    if R.dim() == 2:
        R, t = R[None], t[None]  # outside no_grad: the gradient goes through them
    with torch.no_grad():
        r1, c1 = slot_reconstruction(moved, lines, kmax)
        r2, c2 = slot_reconstruction(neis2, lines, kmax)
        Rd, td = R.detach(), t.detach()
        u = [r1[..., k] - td[:, k, None, None] for k in range(3)]
        raw = [u[0] * Rd[:, c, 0, None, None] + u[1] * Rd[:, c, 1, None, None]
               + u[2] * Rd[:, c, 2, None, None] for c in range(3)]
    fwd = [raw[0] * R[:, 0, c, None, None] + raw[1] * R[:, 1, c, None, None]
           + raw[2] * R[:, 2, c, None, None] + t[:, c, None, None] for c in range(3)]
    f1 = _filled(c1, kmax)
    pts1 = torch.stack([torch.where(f1, f / NNEI, 0.0) for f in fwd], dim=-1)
    pts2 = torch.where(_filled(c2, kmax)[..., None], r2 / NNEI, 0.0)
    return robust_loss(pts1, pts2, c1, c2, kmin, kmax)


# ---------------------------------------------------------------------------
# SE(3) and Adam
# ---------------------------------------------------------------------------

def _branch(t, small, exact):
    """where(|t| < 0.01, the Taylor polynomial, the closed form), finite in
    value and gradient on both sides."""
    is_small = t.abs() < 0.01
    return torch.where(is_small, small(t), exact(torch.where(is_small, torch.ones_like(t), t)))


def _sinc1(t):
    return _branch(t, lambda t: 1 - t**2 / 6 * (1 - t**2 / 20 * (1 - t**2 / 42)),
                   lambda t: torch.sin(t) / t)


def _sinc2(t):
    return _branch(t, lambda t: 0.5 * (1 - t**2 / 12 * (1 - t**2 / 30 * (1 - t**2 / 56))),
                   lambda t: (1 - torch.cos(t)) / t**2)


def _sinc3(t):
    return _branch(t, lambda t: 1 / 6 * (1 - t**2 / 20 * (1 - t**2 / 42 * (1 - t**2 / 72))),
                   lambda t: (t - torch.sin(t)) / t**3)


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_twist(x):
    """Twist (..., 6), rotation first -> (R, t) applied as p @ R + t:
    Rodrigues' formula and the left Jacobian V."""
    w, v = x[..., 0:3], x[..., 3:6]
    t2 = (w * w).sum(-1)
    zero = t2 == 0
    th = torch.where(zero, torch.zeros_like(t2),
                     torch.sqrt(torch.where(zero, torch.ones_like(t2), t2)))[..., None, None]
    W = _hat(w)
    S = mm(W, W)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    R = eye + _sinc1(th) * W + _sinc2(th) * S
    V = eye + _sinc2(th) * W + _sinc3(th) * S
    return R, einsum("...ij,...j->...i", V, v)


B1, B2, EPS = 0.9, 0.999, 1e-8


def adam(lr, grads, count, mu, nu, params, keep):
    """One Adam step (optax's arithmetic) where ``keep`` holds; elsewhere
    the parameters and moments stay, and the count stays where no entry
    keeps. -> (params, count, mu, nu)."""
    mu2 = (1 - B1) * grads + B1 * mu
    nu2 = (1 - B2) * (grads * grads) + B2 * nu
    c = count + 1
    step = -lr * ((mu2 / (1 - B1 ** c)) / (torch.sqrt(nu2 / (1 - B2 ** c)) + EPS))
    return (torch.where(keep, params + step, params), torch.where(keep.any(), c, count),
            torch.where(keep, mu2, mu), torch.where(keep, nu2, nu))
