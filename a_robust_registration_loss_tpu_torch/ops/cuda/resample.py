"""Candidate stage of the line resampler: the kernel ``csrc/resample.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``a_robust_registration_loss_tpu/ops/pallas/
resample.py:_kernel`` (launched by ``sample_and_hit``). Per candidate: two
sphere points from 4 uniforms, direction = their normalised difference,
origin = first point + centre, then the barycentric any-hit test against
two 12-triangle AABB meshes; accepted iff both meshes are hit.

The uniforms are drawn outside and fed in, so a test can hand both this and
the JAX kernel the same draw. Per-face constants come from ``prep_faces``
(plain PyTorch on either device). The plain version follows the kernel op
for op: the barycentric accept sits on a rounding knife edge (A+B+C == S
in real arithmetic for an interior hit), so any re-association moves
labels. Kernel and plain version are held to candidate geometry within
1e-4, label disagreement at most 0.1% and acceptance rate within 10%.

Bound on the H100: fp32 operations, 1,990 per candidate
(``OPS_PER_CANDIDATE``): 5.9 us at C = 200,000 and 67 TFLOP/s, against
2.4 us for its 8.2 MB at 3.35 TB/s. ``chip_smoke.py`` reports it beside the
measured time.
"""

from __future__ import annotations

import math

import torch

from a_robust_registration_loss_tpu_torch._device import sqrt_rn
from a_robust_registration_loss_tpu_torch.ops.cuda import _build

NF = 12  # faces per AABB mesh
OPS_PER_CANDIDATE = 2 * NF * 81 + 46  # fp32 operations, counted in the .cu

launches = 0  # kernel launches since the last reset (plain runs not counted)


def sphere_points(u_alpha, u_u, r):
    """(alpha, u) uniforms -> points (n, 3) on the radius-r sphere.

    cos and sin are taken in float64 and rounded once, as the kernel does:
    the correctly rounded fp32 values, the same on every device."""
    alpha = (u_alpha * 2.0 * math.pi).double()
    u = u_u * 2.0 - 1.0
    s = sqrt_rn(torch.clamp_min(1.0 - u * u, 0.0))
    cos, sin = torch.cos(alpha).to(u.dtype), torch.sin(alpha).to(u.dtype)
    return torch.stack([r * (s * cos), r * (s * sin), r * u], dim=-1)


def sample_candidates(u4, r, center):
    """(4, C) uniforms -> (C, 6) lines [direction | origin]."""
    q1 = sphere_points(u4[0], u4[1], r)
    q2 = sphere_points(u4[2], u4[3], r)
    d = q2 - q1
    norm = sqrt_rn(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    d = d / torch.clamp_min(norm, 1e-12)[:, None]  # F.normalize semantics
    return torch.cat([d, q1 + center.reshape(1, 3)], dim=-1)


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def face_hit(p0, p1, p2, nh, S, lines):
    """Barycentric hit of lines (L, 6) against one triangle: p0, p1, p2, nh
    are 3-sequences of scalars, S the parallelogram area. (L,) bool."""
    d = [lines[:, c] for c in range(3)]
    o = [lines[:, 3 + c] for c in range(3)]
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
    """(12, 9) x 2 face vertices -> (24, 16) rows [p0 p1 p2 nh S pad]: the
    unit normal and parallelogram area of every face."""
    fvs = torch.cat([fvs1, fvs2], dim=0)
    p0, p1, p2 = fvs[:, 0:3], fvs[:, 3:6], fvs[:, 6:9]
    e1, e2 = p1 - p0, p2 - p0
    n = torch.stack(cross3([e1[:, c] for c in range(3)],
                            [e2[:, c] for c in range(3)]), dim=-1)
    S = sqrt_rn(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2])
    inv = 1.0 / torch.clamp_min(S, 1e-12)
    nh = n * inv[:, None]
    pad = torch.zeros((fvs.shape[0], 3), dtype=fvs.dtype, device=fvs.device)
    return torch.cat([p0, p1, p2, nh, S[:, None], pad], dim=-1).contiguous()


def _mesh_hit(rows, lines):
    hit = None
    for f in range(rows.shape[0]):
        row = rows[f]
        h = face_hit(row[0:3], row[3:6], row[6:9], row[9:12], row[12], lines)
        hit = h if hit is None else hit | h
    return hit


def sample_and_hit_reference(u4, r, center, fv_prep):
    """Plain PyTorch version of the kernel: (cand (C, 6), ok (C,) bool)."""
    cand = sample_candidates(u4, r, center)
    ok = _mesh_hit(fv_prep[:NF], cand) & _mesh_hit(fv_prep[NF:], cand)
    return cand, ok


def sample_and_hit(u4, r, center, fv_prep):
    """u4 (4, C) uniforms, r and center (3,) the sampling sphere, fv_prep
    (24, 16) from ``prep_faces`` -> (cand (C, 6), ok (C,) bool).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    global launches
    if u4.device.type == "cpu":
        return sample_and_hit_reference(u4, r, center, fv_prep)
    if u4.device.type != "cuda":
        raise ValueError(f"sample_and_hit: unsupported device {u4.device}")
    dev = u4.device
    if u4.dim() != 2 or u4.shape[0] != 4:
        raise ValueError(f"sample_and_hit: u4 must be (4, C), got {tuple(u4.shape)}")
    if fv_prep.shape != (2 * NF, 16):
        raise ValueError(f"sample_and_hit: fv_prep must be (24, 16), got {tuple(fv_prep.shape)}")
    for name, x in (("u4", u4), ("fv_prep", fv_prep), ("center", center)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"sample_and_hit: {name} must be float32 on {dev}")
    C = u4.shape[1]
    u4 = u4.contiguous()
    fv_prep = fv_prep.contiguous()
    params = torch.cat([torch.as_tensor(r, dtype=torch.float32, device=dev).reshape(1),
                        center.reshape(3)])
    cand = torch.empty((C, 6), dtype=torch.float32, device=dev)
    ok = torch.empty((C,), dtype=torch.uint8, device=dev)
    if C == 0:
        return cand, ok.view(torch.bool)
    lib = _build.library()
    rc = lib.arrl_resample(u4.data_ptr(), C, params.data_ptr(),
                           fv_prep.data_ptr(), cand.data_ptr(), ok.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "arrl_resample")
    launches += 1
    return cand, ok.view(torch.bool)
