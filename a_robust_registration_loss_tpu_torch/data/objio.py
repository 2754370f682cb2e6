"""Wavefront OBJ point-cloud IO, pure Python.

The port's own copy of ``a_robust_registration_loss_tpu/data/objio.py``'s
pure-Python path (its native fast path is not ported yet). Only vertices
and triangular faces are read; point clouds are written without faces.
"""

from __future__ import annotations

import os

import numpy as np


def read_obj(path: str):
    """Read an OBJ file -> (vertices (N, 3) float32, faces (F, 3) int32).

    Handles ``v x y z`` and ``f a b c`` (1-based, with optional /vt/vn
    suffixes); everything else is ignored."""
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                parts = line.split()[1:4]
                faces.append(tuple(int(p.split("/")[0]) - 1 for p in parts))
    v = np.asarray(verts, dtype=np.float32).reshape(-1, 3)
    fc = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    return v, fc


def write_obj(path: str, vertices, faces=None):
    """Write vertices (N, 3) (+ optional 0-based faces (F, 3)) as OBJ."""
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.8g} {v[1]:.8g} {v[2]:.8g}\n")
        if faces is not None:
            for face in np.asarray(faces, dtype=np.int64).reshape(-1, 3):
                f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
