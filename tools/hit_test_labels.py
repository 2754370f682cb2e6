#!/usr/bin/env python3
"""Take the resampler's hit test apart on ``chip_smoke.py``'s DCP pairs at
a tight radius.

    python3 tools/hit_test_labels.py [--pairs 0,1,2,3] [--candidates 20000] [--seed 1]
                                     [--device cpu] [--jax]

For each pair of DCP's first batch (``chip_smoke.dcp_points``), lines are
drawn through the sphere of a tenth of the target box's diagonal
(``TIGHT``) about the target's centroid: a sphere inside both boxes. For
each of the two box meshes (1 the source's, 2 the target's) it prints:

- ``margin``: the least distance from the sphere's centre to a face of the
  box, over the radius (float64). Above 1, every line through the sphere
  crosses the box;
- ``hit_share``: the share of lines that the plain candidate stage
  (``sample_and_hit_reference``, the kernel's bits) labels as hitting it;
- per face, ``crossing``: the lines that cross the face by a float64
  orientation test, ``passed``: how many of those the float32 test
  A > 0, B > 0, C > 0, A + B + C <= S passes, and ``passed_not_crossing``:
  how many it passes that do not cross.

``--jax`` (where the JAX package and JAX are installed, on the CPU) also
labels the same candidates with the JAX package's ``triangle_hits`` and
prints the share of lines on which its labels agree with the port's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TIGHT = 0.1  # the sphere's radius over the target box's diagonal


def face_counts(row, cand):
    """One prepped face row (16,) [p0 p1 p2 nh S pad] against lines
    (L, 6): {crossing, passed, passed_not_crossing} (module docstring)."""
    import torch

    from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS

    k = [row[j] for j in range(13)]
    passed = RS.face_hit(k[0:3], k[3:6], k[6:9], k[9:12], k[12], cand)
    P = row[:9].double().reshape(3, 3)
    d, o = cand[:, :3].double(), cand[:, 3:6].double()
    nrm = torch.linalg.cross(P[1] - P[0], P[2] - P[0])
    x = o + (((P[0] - o) @ nrm) / (d @ nrm))[:, None] * d
    side = [torch.linalg.cross((P[(i + 1) % 3] - P[i]).expand_as(x), x - P[i]) @ nrm
            for i in range(3)]
    crossing = (side[0] > 0) & (side[1] > 0) & (side[2] > 0)
    return dict(crossing=int(crossing.sum()), passed=int((passed & crossing).sum()),
                passed_not_crossing=int((passed & ~crossing).sum()))


def jax_hits(vertices, cand):
    """The JAX package's ``triangle_hits`` of lines cand (L, 6) against the
    box mesh of vertices (N, 3), on the CPU: (L,) bool."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from a_robust_registration_loss_tpu.ops import geometry as JG
    from a_robust_registration_loss_tpu.ops import lines as JL

    fv = JG.bbox_face_vertices(jnp.asarray(vertices.cpu().numpy())[None])[0]
    return np.asarray(JL.triangle_hits(fv, jnp.asarray(cand.cpu().numpy()))) > 0


def labels(pair=1, candidates=20000, seed=1, device="cpu", with_jax=False):
    """The readings of the module docstring for one pair, as a dict; with
    ``with_jax`` also the labels of both packages, as numpy bools
    (``port_hits``, ``jax_hits``: (2, L), one row a mesh)."""
    import torch

    import chip_smoke as CS
    from a_robust_registration_loss_tpu_torch.ops import geometry as G
    from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS

    src, tar, _, _ = CS.dcp_points()
    src, tar = (torch.tensor(v[pair], device=device) for v in (src, tar))
    box = G.bounding_box_corners(tar[None])[0]
    r = torch.linalg.vector_norm(box[0] - box[-1]) * TIGHT
    centre = tar.mean(0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u4 = torch.rand((4, candidates), generator=gen, device=device)
    fv = RS.prep_faces(G.bbox_face_vertices(src[None]), G.bbox_face_vertices(tar[None]))[0]
    cand, ok = RS.sample_and_hit_reference(u4, r, centre, fv)
    out = dict(pair=pair, radius=float(r), candidates=candidates,
               accepted_share=float(ok.float().mean()))
    port, ref = [], []
    for mesh, v in ((1, src), (2, tar)):
        rows = fv[(mesh - 1) * RS.NF:mesh * RS.NF]
        c = centre.double()
        lo, hi = v.amin(0).double(), v.amax(0).double()
        hit = RS._mesh_hit(rows, cand)
        rec = dict(margin=float(torch.minimum(c - lo, hi - c).min() / r.double()),
                   hit_share=float(hit.float().mean()),
                   faces=[face_counts(rows[f], cand) for f in range(RS.NF)])
        if with_jax:
            port.append(hit.cpu().numpy())
            ref.append(jax_hits(v, cand))
            rec["jax_agreement"] = float(np.mean(port[-1] == ref[-1]))
        out[f"mesh{mesh}"] = rec
    if with_jax:
        out["port_hits"], out["jax_hits"] = np.stack(port), np.stack(ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", default="0,1,2,3")
    ap.add_argument("--candidates", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args(argv)
    found = []
    for pair in (int(p) for p in args.pairs.split(",")):
        rec = labels(pair, args.candidates, args.seed, args.device, args.jax)
        rec.pop("port_hits", None)
        rec.pop("jax_hits", None)
        print(json.dumps(rec), flush=True)
        found.append(rec)
    return found


if __name__ == "__main__":
    main()
