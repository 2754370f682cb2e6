"""The one generator of the benchmark's inputs: pairs of point clouds of
smooth closed surfaces, noised, the target moved by a planted rigid motion,
all drawn from the run's seed and a traffic file's parameters
(``portbench/traffic/<traffic>.json``).

A surface is star-shaped about the origin: radius 1 + sum_j a_j sin(f_j .
d + phi_j) along the unit direction d, six terms of low frequency, then
scaled per axis. Two independent samples of it, each with Gaussian noise,
are the source and the target; the target is then moved. Everything comes
from ``numpy.random.default_rng((seed, stream, index))``, so a seed gives
the same pairs whatever else the run does, and two seeds differ.

Parameters a traffic file gives (each a number):
- ``points``: points a cloud; ``noise``: the noise's standard deviation;
- ``max_deg`` and ``max_trans``: a motion about a uniform axis by an angle
  uniform in [0, max_deg] degrees, and a translation of uniform direction
  and length uniform in [0, max_trans] (the classical cells); or
- ``euler_max_deg`` and ``trans_range``: DCP's protocol, angles uniform in
  [0, euler_max_deg] about x, y and z, R = Rx Ry Rz, and a translation
  uniform in [-trans_range, trans_range] per axis.
Other keys (epochs, batch sizes, pair counts) are read by the runners.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

STREAM_PAIR = 1      # the stream of a request's or a dataset item's pair
STREAM_WARMUP = 3    # the stream of the warm-up's pairs
TERMS = 6            # sine terms of a surface


def load(name: str, root: str = HERE) -> dict:
    """The parameters of traffic ``name``."""
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _surface_sample(rng, shape, n: int):
    """n points of the surface ``shape`` = (freq (T, 3), phase (T,), amp
    (T,), scale (3,)) at uniform random directions."""
    freq, phase, amp, scale = shape
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 1.0 + np.sin(d @ freq.T + phase) @ amp
    return (d * r[:, None]) * scale


def _rotation(axis, angle):
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _euler(ax, ay, az):
    cx, sx, cy, sy, cz, sz = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def pair(spec: dict, seed: int, index: int, stream: int = STREAM_PAIR):
    """Pair ``index`` of the run: (src (N, 3), tar (N, 3) float32, R_col
    (3, 3), t (3,) float64) with tar = R_col src' + t for the surface
    points before noise, column convention (p' = R p + t)."""
    rng = np.random.default_rng((seed % 2**64, stream, index))
    n = int(spec["points"])
    freq = rng.standard_normal((TERMS, 3))
    freq *= rng.uniform(1.0, 3.0, (TERMS, 1)) / np.linalg.norm(freq, axis=1, keepdims=True)
    shape = (freq, rng.uniform(0.0, 2 * np.pi, TERMS), rng.uniform(0.0, 0.08, TERMS),
             rng.uniform(0.6, 1.0, 3))
    a = _surface_sample(rng, shape, n) + rng.standard_normal((n, 3)) * spec["noise"]
    b = _surface_sample(rng, shape, n) + rng.standard_normal((n, 3)) * spec["noise"]
    if "euler_max_deg" in spec:
        R = _euler(*np.deg2rad(rng.uniform(0.0, spec["euler_max_deg"], 3)))
        t = rng.uniform(-spec["trans_range"], spec["trans_range"], 3)
    else:
        R = _rotation(rng.standard_normal(3), np.deg2rad(rng.uniform(0.0, spec["max_deg"])))
        d = rng.standard_normal(3)
        t = d / np.linalg.norm(d) * rng.uniform(0.0, spec["max_trans"])
    tar = b @ R.T + t
    return a.astype(np.float32), tar.astype(np.float32), R, t


def box_corners(v):
    """The 8 corners of a cloud's box, corner 0 the max and 7 the min."""
    mx, mn = v.max(0), v.min(0)
    return np.array([[(mn if a else mx)[0], (mn if b else mx)[1], (mn if c else mx)[2]]
                     for a in (0, 1) for b in (0, 1) for c in (0, 1)], np.float32)


def dcp_item(src, tar, R_col, t):
    """One pair in the dataset contract's DCP form (rotations in column
    convention), without its neighbourhoods: the clouds centred, the
    motion between the centred clouds, its inverse, the target's box and
    centre, zero normals."""
    c_src, c_tar = src.mean(0), tar.mean(0)
    src, tar = src - c_src, tar - c_tar
    # tar - c_tar = R (src - c_src) + T in the centred frames
    T = t + R_col @ c_src.astype(np.float64) - c_tar
    igt = np.eye(4)
    igt[:3, :3] = R_col
    igt[:3, 3] = -R_col.T @ T
    return {
        "points_tar_sample": tar.astype(np.float32),
        "points_src_sample": src.astype(np.float32),
        "normals_tar": np.zeros_like(tar, np.float32),
        "normals_src": np.zeros_like(src, np.float32),
        "tar_box": box_corners(tar),
        "centers": tar.mean(0).astype(np.float32),
        "R": R_col.astype(np.float32),
        "T": T.astype(np.float32),
        "R_inv": R_col.T.astype(np.float32),
        "T_inv": (-R_col.T @ T).astype(np.float32),
        "igt": igt.astype(np.float32),
    }
