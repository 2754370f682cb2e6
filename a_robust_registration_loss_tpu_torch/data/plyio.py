"""PLY reader and writer (ascii and binary_little_endian).

The port's own copy of ``a_robust_registration_loss_tpu/data/plyio.py``.
The reader takes vertex x/y/z and triangular faces (larger polygons
fan-triangulated); other vertex properties are read and discarded. The
writer writes the same bytes as the JAX package's: vertices, optional
triangle faces and optional uniform or per-vertex colours.
"""

from __future__ import annotations

import struct

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _read_header(f, path):
    if f.readline().strip() != b"ply":
        raise ValueError(f"{path}: not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop, dtype) | ("list", idx_dt, val_dt, name)])
    while True:
        line = f.readline()
        if not line:
            raise ValueError(f"{path}: unexpected EOF in header")
        parts = line.decode("ascii", "replace").strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))
        elif parts[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
    return fmt, elements


def _fan(idx, faces):
    for k in range(1, len(idx) - 1):
        faces.append((idx[0], idx[k], idx[k + 1]))


def _read_binary_rows(f, count, props):
    rows = []
    for _ in range(count):
        row = []
        for p in props:
            if p[0] == "list":
                idt = np.dtype("<" + _PLY_DTYPES[p[1]])
                vdt = np.dtype("<" + _PLY_DTYPES[p[2]])
                n = int(np.frombuffer(f.read(idt.itemsize), idt)[0])
                row.append(np.frombuffer(f.read(vdt.itemsize * n), vdt))
            else:
                pdt = np.dtype("<" + _PLY_DTYPES[p[1]])
                row.append(np.frombuffer(f.read(pdt.itemsize), pdt)[0])
        rows.append(row)
    return rows


def read_ply(path: str):
    """Read a PLY file -> (vertices (N, 3) float32, faces (F, 3) int32)."""
    vertices, faces = [], []
    with open(path, "rb") as f:
        fmt, elements = _read_header(f, path)
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    keys = [p[0] for p in props]
                    ix, iy, iz = keys.index("x"), keys.index("y"), keys.index("z")
                    vertices = [(float(r[ix]), float(r[iy]), float(r[iz]))
                                for r in rows]
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        _fan([int(v) for v in r[1:1 + n]], faces)
            elif name == "vertex" and all(p[0] != "list" for p in props):
                dt = np.dtype([(p[0], "<" + _PLY_DTYPES[p[1]]) for p in props])
                arr = np.frombuffer(f.read(dt.itemsize * count), dt)
                vertices = np.stack([arr["x"], arr["y"], arr["z"]], -1)
            else:
                for row in _read_binary_rows(f, count, props):
                    if name == "face" and row:
                        _fan([int(v) for v in np.asarray(row[0])], faces)
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    fc = np.asarray(faces, np.int32).reshape(-1, 3)
    return v, fc


def write_ply(path: str, vertices, faces=None, binary: bool = False,
              colors=None):
    """Write vertices (N, 3) (+ optional triangle faces) as PLY.

    ``colors``: optional (3,) uniform or (N, 3) per-vertex colours, floats
    in [0, 1] or integers in [0, 255] (clipped), written as uchar."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    fc = None if faces is None else np.asarray(faces, np.int32).reshape(-1, 3)
    col = None
    if colors is not None:
        col = np.asarray(colors)
        if np.issubdtype(col.dtype, np.integer):
            col = np.clip(col, 0, 255).astype(np.uint8)
        else:
            col = (np.clip(col, 0.0, 1.0) * 255).astype(np.uint8)
        col = np.broadcast_to(col.reshape(-1, 3), (len(v), 3))
    fmt = "binary_little_endian" if binary else "ascii"
    header = ["ply", f"format {fmt} 1.0", f"element vertex {len(v)}",
              "property float x", "property float y", "property float z"]
    if col is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if fc is not None:
        header += [f"element face {len(fc)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if col is None:
                f.write(v.astype("<f4").tobytes())
            else:
                dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("red", "u1"), ("green", "u1"), ("blue", "u1")])
                rec = np.empty(len(v), dt)
                rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
                rec["red"], rec["green"], rec["blue"] = col[:, 0], col[:, 1], col[:, 2]
                f.write(rec.tobytes())
            if fc is not None:
                for face in fc:
                    f.write(struct.pack("<B3i", 3, *face))
        else:
            for i, p in enumerate(v):
                row = f"{p[0]:.8g} {p[1]:.8g} {p[2]:.8g}"
                if col is not None:
                    row += f" {col[i, 0]} {col[i, 1]} {col[i, 2]}"
                f.write((row + "\n").encode())
            if fc is not None:
                for face in fc:
                    f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode())
