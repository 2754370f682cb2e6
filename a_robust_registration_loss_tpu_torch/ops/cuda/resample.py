"""Candidate stage of the line resampler: the kernel ``csrc/resample.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``a_robust_registration_loss_tpu/ops/pallas/
resample.py:_kernel`` (launched by ``sample_and_hit``). Per candidate: two
sphere points from 4 uniforms, direction = their normalised difference,
origin = first point + centre, then the barycentric any-hit test against
two 12-triangle AABB meshes; accepted iff both meshes are hit. Every
argument may carry a leading batch axis (the trainers' per-sample lines):
one launch then serves the batch, where the JAX package vmaps its kernel.

The uniforms are drawn outside and fed in, so a test can hand both this and
the JAX kernel the same draw. Per-face constants come from ``prep_faces``
(plain PyTorch on either device). The plain version follows the kernel op
for op: the barycentric accept sits on a rounding knife edge (A+B+C == S
in real arithmetic for an interior hit), so any re-association moves
labels. The kernel tests mesh 2 for every candidate and mesh 1 only for
those that hit mesh 2 (``&`` is exact), which changes no output: kernel and
plain version are held to equal ``cand`` and ``ok`` bit for bit, on random
draws and on ``adversarial_cases``.

Bound on the H100: fp32 operations, the work these inputs need,
``ops_needed``: 46 + 12 x 81 + p x 12 x 81 per candidate, p the share that
hits mesh 2 (``_mesh_hit``). ``chip_smoke.py`` reports it beside the
measured time, and beside it the bound of 1,990 operations per candidate
(``OPS_PER_CANDIDATE``, both meshes for every candidate) that the rows of
earlier kernels were measured against.
"""

from __future__ import annotations

import collections
import math

import torch

from a_robust_registration_loss_tpu_torch._device import sqrt_rn
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops.cuda import _build

NF = 12  # faces per AABB mesh
OPS_PER_CANDIDATE = 2 * NF * 81 + 46  # fp32 operations, counted in the .cu

# kernel launches since the last reset, by "single" or "batched" (the call
# carried a batch axis); plain runs are not counted
launches: collections.Counter = collections.Counter()


def sphere_points(u_alpha, u_u, r):
    """(alpha, u) uniforms (..., n) -> points (..., n, 3) on the radius-r
    sphere (r a scalar, or (B,) for uniforms (B, n)).

    cos and sin are taken in float64 and rounded once, as the kernel does:
    the correctly rounded fp32 values, the same on every device."""
    r = torch.as_tensor(r, dtype=u_u.dtype, device=u_u.device)[..., None]
    alpha = (u_alpha * 2.0 * math.pi).double()
    u = u_u * 2.0 - 1.0
    s = sqrt_rn(torch.clamp_min(1.0 - u * u, 0.0))
    cos, sin = torch.cos(alpha).to(u.dtype), torch.sin(alpha).to(u.dtype)
    return torch.stack([r * (s * cos), r * (s * sin), r * u], dim=-1)


def sample_candidates(u4, r, center):
    """(..., 4, C) uniforms -> (..., C, 6) lines [direction | origin]; r
    and center (3,) carry the same leading batch axis as u4, if any."""
    q1 = sphere_points(u4[..., 0, :], u4[..., 1, :], r)
    q2 = sphere_points(u4[..., 2, :], u4[..., 3, :], r)
    d = q2 - q1
    norm = sqrt_rn(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    d = d / torch.clamp_min(norm, 1e-12)[..., None]  # F.normalize semantics
    return torch.cat([d, q1 + center[..., None, :]], dim=-1)


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def face_hit(p0, p1, p2, nh, S, lines):
    """Barycentric hit of lines (..., L, 6) against one triangle: p0, p1,
    p2, nh are 3-sequences of scalars (or of tensors that broadcast against
    (..., L)), S the parallelogram area. (..., L) bool."""
    d = [lines[..., c] for c in range(3)]
    o = [lines[..., 3 + c] for c in range(3)]
    denom = nh[0] * d[0] + nh[1] * d[1] + nh[2] * d[2] + 1e-12
    tnum = (nh[0] * (p0[0] - o[0]) + nh[1] * (p0[1] - o[1])
            + nh[2] * (p0[2] - o[2]))
    t = tnum / denom
    i = [t * d[c] + o[c] for c in range(3)]
    cA = [i[c] - p0[c] for c in range(3)]
    cB = [i[c] - p1[c] for c in range(3)]
    cC = [i[c] - p2[c] for c in range(3)]

    def area(u, v):
        w = cross3(u, v)
        return sqrt_rn(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])

    bA, bB, bC = area(cB, cC), area(cC, cA), area(cA, cB)
    return (bA > 0) & (bB > 0) & (bC > 0) & (bA + bB + bC <= S)


def prep_faces(fvs1, fvs2):
    """(..., 12, 9) x 2 face vertices -> (..., 24, 16) rows [p0 p1 p2 nh S
    pad]: the unit normal and parallelogram area of every face."""
    fvs = torch.cat([fvs1, fvs2], dim=-2)
    p0, p1, p2 = fvs[..., 0:3], fvs[..., 3:6], fvs[..., 6:9]
    e1, e2 = p1 - p0, p2 - p0
    n = torch.stack(cross3([e1[..., c] for c in range(3)],
                            [e2[..., c] for c in range(3)]), dim=-1)
    S = sqrt_rn(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] + n[..., 2] * n[..., 2])
    inv = 1.0 / torch.clamp_min(S, 1e-12)
    nh = n * inv[..., None]
    pad = torch.zeros((*fvs.shape[:-1], 3), dtype=fvs.dtype, device=fvs.device)
    return torch.cat([p0, p1, p2, nh, S[..., None], pad], dim=-1).contiguous()


def _mesh_hit(rows, lines):
    """Any-hit of lines (..., L, 6) against the prepped faces rows
    (..., F, 16)."""
    hit = None
    for f in range(rows.shape[-2]):
        # each constant as (..., 1), against the (..., L) line components
        k = [rows[..., f, j, None] for j in range(13)]
        h = face_hit(k[0:3], k[3:6], k[6:9], k[9:12], k[12], lines)
        hit = h if hit is None else hit | h
    return hit


def ops_needed(n_candidates: int, hits2: int) -> int:
    """fp32 operations that ``n_candidates`` candidates need when mesh 1 is
    tested only for the ``hits2`` of them that hit mesh 2."""
    return n_candidates * (46 + NF * 81) + hits2 * NF * 81


def sample_and_hit_reference(u4, r, center, fv_prep):
    """Plain PyTorch version of the kernel: (cand (..., C, 6), ok (..., C)
    bool), with or without a leading batch axis on every argument."""
    cand = sample_candidates(u4, r, center)
    ok = (_mesh_hit(fv_prep[..., :NF, :], cand)
          & _mesh_hit(fv_prep[..., NF:, :], cand))
    return cand, ok


def sample_and_hit(u4, r, center, fv_prep):
    """u4 (4, C) uniforms, r and center (3,) the sampling sphere, fv_prep
    (24, 16) from ``prep_faces`` -> (cand (C, 6), ok (C,) bool); or, with a
    leading batch axis, u4 (B, 4, C), r (B,), center (B, 3), fv_prep
    (B, 24, 16) -> (cand (B, C, 6), ok (B, C)) in one launch.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    if u4.device.type == "cpu":
        return sample_and_hit_reference(u4, r, center, fv_prep)
    if u4.device.type != "cuda":
        raise ValueError(f"sample_and_hit: unsupported device {u4.device}")
    dev = u4.device
    if u4.dim() not in (2, 3) or u4.shape[-2] != 4:
        raise ValueError(f"sample_and_hit: u4 must be (4, C) or (B, 4, C), got {tuple(u4.shape)}")
    lead = tuple(u4.shape[:-2])  # () or (B,)
    if isinstance(r, torch.Tensor) and r.dtype != torch.float32:
        raise ValueError(f"sample_and_hit: r must be float32, got {r.dtype}")
    r = torch.as_tensor(r, dtype=torch.float32, device=dev)
    for name, x, shape in (("r", r, lead), ("center", center, lead + (3,)),
                           ("fv_prep", fv_prep, lead + (2 * NF, 16))):
        if tuple(x.shape) != shape:
            raise ValueError(f"sample_and_hit: {name} must be {shape}, got {tuple(x.shape)}")
    for name, x in (("u4", u4), ("fv_prep", fv_prep), ("center", center)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"sample_and_hit: {name} must be float32 on {dev}")
    B, C = (lead[0] if lead else 1), u4.shape[-1]
    if B > 65535:
        raise ValueError(f"sample_and_hit: batch {B} beyond the grid's 65535")
    u4 = u4.contiguous()
    fv_prep = fv_prep.contiguous()
    params = torch.cat([r[..., None], center], dim=-1)
    cand = torch.empty(lead + (C, 6), dtype=torch.float32, device=dev)
    ok = torch.empty(lead + (C,), dtype=torch.uint8, device=dev)
    if B * C == 0:
        return cand, ok.view(torch.bool)
    lib = _build.library()
    rc = lib.arrl_resample(u4.data_ptr(), B, C, params.data_ptr(),
                           fv_prep.data_ptr(), cand.data_ptr(), ok.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "arrl_resample")
    launches["batched" if lead else "single"] += 1
    return cand, ok.view(torch.bool)


def _box_faces(lo, hi):
    """The 12-triangle face vertices (12, 9) of the box [lo, hi] (3-sequences),
    in the vertex order of ``geometry.bbox_face_vertices``."""
    return G.bbox_face_vertices(torch.tensor([[lo, hi]], dtype=torch.float32))[0]


ADVERSARIAL_CENTER = (0.25, -0.5, 0.125)  # the sampling sphere's, radius 1
ADVERSARIAL_SIZES = (1, 31, 33, 255, 257, 513)  # prefixes of the lattice, on the "cube" boxes
ADVERSARIAL_BOXES = ("cube", "corners", "face_plane", "flat", "inside", "far")
ADVERSARIAL_CASES = (ADVERSARIAL_BOXES + tuple(f"cube C={n}" for n in ADVERSARIAL_SIZES)
                     + ("batch 1", "batch 6"))  # the names of adversarial_cases


def adversarial_cases(device=None):
    """Candidate sets on the knife edges of the resampler, for holding the
    kernel to its plain version: {name: (u4, r, center, fvs1, fvs2)}, the
    face vertices (..., 12, 9) of the two boxes (``prep_faces`` makes the
    kernel's rows).

    The uniforms are a lattice: both sphere points take every pairing of
    the azimuths k/8 (axis-aligned and diagonal directions) and the heights
    u in {-1, -0.5, 0, 0.5, 1} (u = +-1 gives s = 0); 1,600 candidates,
    40 with q1 = q2 (a zero direction), and many parallel to the faces of
    the axis-aligned boxes (denominator 1e-12 exactly). The sphere has
    radius 1 at ``ADVERSARIAL_CENTER``. Boxes, each case both meshes unless
    named:
    - "cube": a cube of side 1 off the sphere's centre by (1/8, 1/16, 0)
      (mesh 1) and one of side 1.5 off it by (-1/16, 1/8, 0) (mesh 2): the
      axis-aligned lines through the centre cross no face diagonal;
    - "corners": half-sides (0.5, 0.5, 0.5 sqrt(2/3)) at the centre: the
      lattice's lines through the centre meet face centres (on the
      diagonal where a face's two triangles meet), edges and corners;
    - "face_plane": a face in the plane y = centre_y, which holds many of
      the lattice's lines;
    - "flat": zero height, whose side faces have S = 0;
    - "inside": a cube that holds the sphere: 80% of the lines hit both
      meshes (the rest leave through a face diagonal, where neither
      triangle takes them, or have no direction), so the kernel's second
      pass has full warps;
    - "far": a small cube far from the sphere, which 1% of the lines hit;
    - "cube C=n": the first n candidates of "cube", n in ADVERSARIAL_SIZES;
    - "batch 1": "corners" with a batch axis of 1; "batch 6": the six
      boxes' cases stacked, one sample each.
    """
    steps = torch.arange(8, dtype=torch.float32) / 8
    heights = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0])
    ua = steps.repeat_interleave(len(heights))
    uu = heights.repeat(len(steps))
    i, j = torch.meshgrid(torch.arange(len(ua)), torch.arange(len(ua)), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    u4 = torch.stack([ua[i], uu[i], ua[j], uu[j]])
    cx, cy, cz = ADVERSARIAL_CENTER
    c = torch.tensor(ADVERSARIAL_CENTER)

    def box(h, shift=(0.0, 0.0, 0.0)):
        return _box_faces([cx + shift[0] - h[0], cy + shift[1] - h[1], cz + shift[2] - h[2]],
                          [cx + shift[0] + h[0], cy + shift[1] + h[1], cz + shift[2] + h[2]])

    third = 0.5 * (2.0 / 3.0) ** 0.5
    boxes = {
        "cube": (box((0.5, 0.5, 0.5), (0.125, 0.0625, 0.0)),
                 box((0.75, 0.75, 0.75), (-0.0625, 0.125, 0.0))),
        "corners": (box((0.5, 0.5, third)),) * 2,
        "face_plane": (_box_faces([cx - 0.5, cy, cz - 0.3], [cx + 0.5, cy + 0.7, cz + 0.3]),) * 2,
        "flat": (box((0.5, 0.4, 0.0)),) * 2,
        "inside": (box((4.0, 4.0, 4.0)),) * 2,
        "far": (box((0.25, 0.25, 0.25), (5.0, 5.0, 5.0)),) * 2,
    }
    one = torch.tensor(1.0)
    cases = {name: (u4, one, c, *boxes[name]) for name in ADVERSARIAL_BOXES}
    for n in ADVERSARIAL_SIZES:
        cases[f"cube C={n}"] = (u4[:, :n].contiguous(), one, c, *boxes["cube"])
    cases["batch 1"] = tuple(x[None] for x in cases["corners"])
    cases["batch 6"] = tuple(torch.stack([cases[name][k] for name in ADVERSARIAL_BOXES])
                             for k in range(5))
    return {name: tuple(x.to(device) for x in case) for name, case in cases.items()}
