"""Partial pairs with normals, RPM-Net's data protocol over the benchmark's
generator (``traffic.py``).

``traffic.pair`` draws a pair of samples of one smooth closed surface, the
target moved. ``pair`` replays its generator calls one for one, so it
gives the same points bit for bit, and keeps what ``traffic.pair`` drops:
each sample's direction, at which the normal of the noise-free surface is
taken (the noise moves a point, not its normal, as jitter leaves a mesh's
normals in RPM-Net), rotated with the target.

``crop`` is then RPM-Net's partial view (Yew and Lee, CVPR 2020,
``data_loader/transforms.py``): ``RandomCrop`` keeps the points above the
(1 - keep) quantile of their distance from a plane through the centroid
with a uniform normal, each cloud cropped on its own; ``Resampler`` then
draws ceil(keep * num_points) of them without replacement. Both draws come
from a stream of their own (``STREAM_CROP``), so ``traffic.pair``'s draws
are untouched.

Parameters a traffic file adds: ``keep`` (RPM-Net's ``partial``, 0.7) and
``num_points`` (its ``num_points``, 1,024); ``points`` is the count before
the crop (2,048 in RPM-Net's ModelNet40).
"""

from __future__ import annotations

import math

import numpy as np

from portbench import traffic as TF

STREAM_CROP = 5  # the seed's stream of the crops' directions and draws


def _sample(rng, shape, n: int):
    """``traffic._surface_sample``'s draw and arithmetic, also returning the
    unit directions: (points (n, 3), directions (n, 3))."""
    freq, phase, amp, scale = shape
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 1.0 + np.sin(d @ freq.T + phase) @ amp
    return (d * r[:, None]) * scale, d


def surface_normals(shape, d):
    """Unit outward normals of the surface ``shape`` at the unit directions
    d (n, 3). The unscaled surface is the zero set of |p| - r(p / |p|),
    whose gradient at p = r(d) d is d - (I - d d^T) grad r(d) / r(d), with
    grad r = sum_j a_j cos(f_j . d + phi_j) f_j; the per-axis scale maps a
    normal by its inverse."""
    freq, phase, amp, scale = shape
    arg = d @ freq.T + phase
    r = 1.0 + np.sin(arg) @ amp
    g = (np.cos(arg) * amp) @ freq
    g_tan = g - (g * d).sum(1, keepdims=True) * d
    n = (d - g_tan / r[:, None]) / scale
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def pair(spec: dict, seed: int, index: int, stream: int = TF.STREAM_PAIR):
    """``traffic.pair`` with normals: (src (N, 3), tar (N, 3), n_src (N, 3),
    n_tar (N, 3) float32, R_col (3, 3), t (3,) float64); src and tar equal
    ``traffic.pair``'s bit for bit, n_tar is rotated by R_col."""
    rng = np.random.default_rng((seed % 2**64, stream, index))
    n = int(spec["points"])
    freq = rng.standard_normal((TF.TERMS, 3))
    freq *= rng.uniform(1.0, 3.0, (TF.TERMS, 1)) / np.linalg.norm(freq, axis=1, keepdims=True)
    shape = (freq, rng.uniform(0.0, 2 * np.pi, TF.TERMS), rng.uniform(0.0, 0.08, TF.TERMS),
             rng.uniform(0.6, 1.0, 3))
    a, da = _sample(rng, shape, n)
    a = a + rng.standard_normal((n, 3)) * spec["noise"]
    b, db = _sample(rng, shape, n)
    b = b + rng.standard_normal((n, 3)) * spec["noise"]
    if "euler_max_deg" in spec:
        R = TF._euler(*np.deg2rad(rng.uniform(0.0, spec["euler_max_deg"], 3)))
        t = rng.uniform(-spec["trans_range"], spec["trans_range"], 3)
    else:
        R = TF._rotation(rng.standard_normal(3), np.deg2rad(rng.uniform(0.0, spec["max_deg"])))
        d = rng.standard_normal(3)
        t = d / np.linalg.norm(d) * rng.uniform(0.0, spec["max_trans"])
    tar = b @ R.T + t
    n_src, n_tar = surface_normals(shape, da), surface_normals(shape, db) @ R.T
    return (a.astype(np.float32), tar.astype(np.float32), n_src.astype(np.float32),
            n_tar.astype(np.float32), R, t)


def crop(rng, points, normals, keep: float, num_points: int):
    """One cloud's partial view: ``RandomCrop`` at ``keep`` (the points
    whose signed distance from the plane through the centroid, of a
    uniform normal, lies above its (1 - keep) * 100th percentile), then
    ``Resampler``'s ceil(keep * num_points) of them drawn without
    replacement. -> (points, normals) of that many rows."""
    direction = rng.standard_normal(3)
    direction /= np.linalg.norm(direction)
    dist = (points - points.mean(0)) @ direction
    kept = np.flatnonzero(dist > np.percentile(dist, (1.0 - keep) * 100))
    pick = kept[rng.choice(kept.size, math.ceil(keep * num_points), replace=False)]
    return points[pick], normals[pick]


def partial_pair(spec: dict, seed: int, index: int, stream: int = TF.STREAM_PAIR):
    """Pair ``index`` of the run cropped: (src, tar, n_src, n_tar, R_col, t),
    each cloud ``crop``ped on its own from the stream (seed, STREAM_CROP,
    stream, index)."""
    src, tar, n_src, n_tar, R, t = pair(spec, seed, index, stream)
    rng = np.random.default_rng((seed % 2**64, STREAM_CROP, stream, index))
    src, n_src = crop(rng, src, n_src, spec["keep"], spec["num_points"])
    tar, n_tar = crop(rng, tar, n_tar, spec["keep"], spec["num_points"])
    return src, tar, n_src, n_tar, R, t


def rpm_item(src, tar, n_src, n_tar, R_col, t):
    """One pair in the dataset contract's plain form, which RPM-Net takes
    (row-convention rotations: tar = src R + T in the centred frames), with
    its normals; without its neighbourhoods. ``traffic.dcp_item`` with the
    DCP adapter's transposes undone."""
    item = TF.dcp_item(src, tar, R_col, t)
    igt = item["igt"].copy()
    igt[:3, :3] = igt[:3, :3].T
    return dict(item, normals_src=n_src, normals_tar=n_tar, R=item["R_inv"], R_inv=item["R"],
                igt=igt)
