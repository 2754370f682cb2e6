"""Wavefront OBJ point-cloud IO.

The port's own copy of ``a_robust_registration_loss_tpu/data/objio.py``.
Only vertices and triangular faces are read; point clouds are written
without faces. A native C++ fast path (``native/objio.cpp``, built on first
use into ``build/torch_native/``) is used when it builds; the pure-Python
path is the fallback and the semantics oracle. ``backend()`` says which
one a run reads and writes with.
"""

from __future__ import annotations

import os

import numpy as np


def _native():
    from a_robust_registration_loss_tpu_torch.native import objio_native

    return objio_native if objio_native.available() else None


def backend() -> str:
    """``"native"`` when the C++ library is loaded, else ``"python"``."""
    return "native" if _native() is not None else "python"


def read_obj(path: str):
    """Read an OBJ file -> (vertices (N, 3) float32, faces (F, 3) int32).

    Handles ``v x y z`` and ``f a b c`` (1-based, with optional /vt/vn
    suffixes); everything else is ignored. A missing file raises."""
    nat = _native()
    if nat is not None:
        return nat.read_obj(path)
    return read_obj_python(path)


def read_obj_python(path: str):
    """``read_obj``'s pure-Python path."""
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
    nat = _native()
    if nat is not None:
        nat.write_obj(path, vertices, faces)
        return
    write_obj_python(path, vertices, faces)


def write_obj_python(path: str, vertices, faces=None):
    """``write_obj``'s pure-Python path."""
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.8g} {v[1]:.8g} {v[2]:.8g}\n")
        if faces is not None:
            for face in np.asarray(faces, dtype=np.int64).reshape(-1, 3):
                f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
