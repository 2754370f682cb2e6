"""Uniform random line sampling with bounding-box rejection resampling.

Port of ``a_robust_registration_loss_tpu/ops/lines.py``. The measure is the
uniform one on lines through a radius-r sphere: two uniform sphere points,
direction = their normalised difference, origin = first point + centre.
The resampler keeps the first n candidates that hit both clouds' 12-triangle
AABB meshes, out of ``ROUNDS * n`` candidates, zero-filling the tail (zero
lines intersect nothing downstream).

The uniforms come in as a ``(4, ROUNDS * n)`` tensor: the production loop
draws them from a ``torch.Generator``, and a test can hand in the JAX
draw. The candidate stage is the kernel of ``ops/cuda/resample.py`` on a
CUDA tensor and its plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch._device import sqrt_rn
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS

ROUNDS = 10  # candidate budget per kept line, the reference's


def sample_lines(u4, r, center):
    """(4, n) uniforms -> n lines (n, 6) [direction | point] through the
    radius-r sphere at ``center``."""
    return RS.sample_candidates(u4, r, center)


def triangle_hits(face_vertices, lines):
    """Hit counts (L,) int32 of lines (L, 6) against a triangle soup
    face_vertices (F, 9) [p0|p1|p2]: the barycentric parallelogram-area test
    A > 0, B > 0, C > 0, A + B + C <= S (the line is infinite)."""
    count = torch.zeros(lines.shape[0], dtype=torch.int32, device=lines.device)
    for f in range(face_vertices.shape[0]):
        fv = face_vertices[f]
        p0, p1, p2 = fv[0:3], fv[3:6], fv[6:9]
        n = RS.cross3([p1[c] - p0[c] for c in range(3)],
                       [p2[c] - p0[c] for c in range(3)])
        S = sqrt_rn(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
        inv = 1.0 / torch.clamp_min(S, 1e-12)
        nh = [n[c] * inv for c in range(3)]
        count += RS.face_hit(p0, p1, p2, nh, S, lines).int()
    return count


def _fill_first_n_gather(cand, ok, n: int):
    """Keep the first n accepted candidates, in order, zero-filled tail.

    cumsum ranks and one scatter into an (n + 1)-row buffer whose last row
    is a dump for the rejected and surplus candidates: no host sync."""
    pos = torch.cumsum(ok, dim=0) - 1
    dest = torch.where(ok & (pos < n), pos, n)
    out = torch.zeros((n + 1, cand.shape[1]), dtype=cand.dtype,
                      device=cand.device)
    out.index_copy_(0, dest, cand)
    return out[:n]


def resample_lines(u4, r, center, n: int, vertices1, vertices2):
    """Rejection resampling of n lines hitting both clouds' AABB meshes.

    u4 (4, ROUNDS * n) uniforms; r, center the sampling sphere; vertices1/2
    (N, 3). Returns (n, 6)."""
    fvs1 = G.bbox_face_vertices(vertices1[None])[0]
    fvs2 = G.bbox_face_vertices(vertices2[None])[0]
    cand, ok = RS.sample_and_hit(u4, r, center, RS.prep_faces(fvs1, fvs2))
    return _fill_first_n_gather(cand, ok, n)
