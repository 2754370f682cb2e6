"""Host-side point-cloud augmentation transforms, numpy.

The port's own copy of ``a_robust_registration_loss_tpu/data/transforms.py``:
the same functions, the same calls on the explicit ``np.random.Generator``
in the same order, so one seed gives the same data on both sides. They run
in the data pipeline on the host, as the reference's dataloader-side
transforms do.

Conventions: points are (N, 3) row vectors; homogeneous transforms are
(4, 4) column-vector convention (p' = R p + t), as the port's ``se3``
module. ``random_transform_se3`` returns (p1, gt, igt) with igt: p0 -> p1
and gt = igt^{-1}.
"""

from __future__ import annotations

import numpy as np


def _so3_exp(w):
    """Rodrigues: (3,) -> (3, 3), numpy, Taylor-safe near 0."""
    t = np.linalg.norm(w)
    W = np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]],
        dtype=np.float64,
    )
    if t < 1e-7:
        return np.eye(3) + W + 0.5 * (W @ W)
    return np.eye(3) + (np.sin(t) / t) * W + ((1 - np.cos(t)) / t**2) * (W @ W)


def _se3_exp(x):
    """Twist (6,) [w | v] -> (4, 4) homogeneous transform (column convention),
    matching se3.exp (reference: LieAlgebra/se3.py:57-80)."""
    w, v = np.asarray(x[:3], np.float64), np.asarray(x[3:], np.float64)
    t = np.linalg.norm(w)
    W = np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]],
        dtype=np.float64,
    )
    if t < 1e-7:
        R = np.eye(3) + W + 0.5 * (W @ W)
        V = np.eye(3) + 0.5 * W + (W @ W) / 6.0
    else:
        R = np.eye(3) + (np.sin(t) / t) * W + ((1 - np.cos(t)) / t**2) * (W @ W)
        V = (
            np.eye(3)
            + ((1 - np.cos(t)) / t**2) * W
            + ((t - np.sin(t)) / t**3) * (W @ W)
        )
    g = np.eye(4)
    g[:3, :3] = R
    g[:3, 3] = V @ v
    return g


def transform_points(g, points):
    """Apply a (4, 4) column-convention transform to (N, 3) points."""
    pts = np.asarray(points, np.float64)
    return (pts @ np.asarray(g)[:3, :3].T + np.asarray(g)[:3, 3]).astype(
        np.asarray(points).dtype
    )


def on_unit_sphere(points, zero_mean: bool = False):
    """Scale to max-norm 1 (reference: transforms.py:21-33)."""
    v = np.asarray(points, np.float32)
    if zero_mean:
        v = v - v.mean(0, keepdims=True)
    return v / np.linalg.norm(v, axis=1).max()


def on_unit_cube(points):
    """The reference's OnUnitCube.method2 (the one its __call__ uses,
    transforms.py:47-55): divide by the largest bbox extent, then zero-mean."""
    v = np.asarray(points, np.float32)
    extent = (v.max(0) - v.min(0)).max()
    v = v / extent
    return v - v.mean(0, keepdims=True)


def resample(points, num: int, rng: np.random.Generator):
    """[N, D] -> [num, D] by cycling random permutations — every point appears
    floor(num/N) or ceil(num/N) times (reference: transforms.py:58-76)."""
    pts = np.asarray(points)
    n = pts.shape[0]
    out = np.zeros((num, pts.shape[1]), pts.dtype)
    selected = 0
    while selected < num:
        sel = min(num - selected, n)
        idx = rng.permutation(n)[:sel]
        out[selected : selected + sel] = pts[idx]
        selected += sel
    return out


def random_jitter(points, rng: np.random.Generator, scale: float = 0.01,
                  clip: float = 0.05):
    """Clipped gaussian perturbation (reference: transforms.py:132-148).
    Returns (jittered points, the noise)."""
    pts = np.asarray(points, np.float32)
    noise = np.clip(
        rng.normal(0.0, scale, pts.shape).astype(np.float32), -clip, clip
    )
    return pts + noise, noise


def random_translate(points, rng: np.random.Generator, mag: float = 1.0,
                     randomly: bool = True):
    """Random unit-direction translation of magnitude <= mag
    (reference: transforms.py:79-96). Returns (p1, igt (4, 4))."""
    amp = rng.random() if randomly else 1.0
    t = rng.standard_normal(3)
    t = t / np.linalg.norm(t) * amp * mag
    g = np.eye(4)
    g[:3, 3] = t
    return (np.asarray(points, np.float32) + t.astype(np.float32)), g


def random_rotator(points, rng: np.random.Generator, mag: float = np.pi,
                   randomly: bool = True):
    """Random-axis rotation of angle <= mag (reference: transforms.py:99-115).
    Returns (p1, R (3, 3))."""
    amp = rng.random() if randomly else 1.0
    w = rng.standard_normal(3)
    w = w / np.linalg.norm(w) * amp * mag
    R = _so3_exp(w)
    pts = np.asarray(points, np.float64) @ R.T
    return pts.astype(np.float32), R


def random_rotator_z(points, rng: np.random.Generator):
    """Uniform rotation about z (reference: transforms.py:118-129)."""
    ang = rng.random() * 2 * np.pi
    R = _so3_exp(np.array([0.0, 0.0, ang]))
    return (np.asarray(points, np.float64) @ R.T).astype(np.float32), R


def random_twist(rng: np.random.Generator, mag: float = 1.0,
                 mag_randomly: bool = False):
    """A random twist of norm mag (or uniform in (0, mag))
    (reference: transforms.py:161-175)."""
    amp = rng.random() * mag if mag_randomly else mag
    x = rng.standard_normal(6)
    return (x / np.linalg.norm(x) * amp).astype(np.float32)


def random_crop(points, rng: np.random.Generator, keep_ratio: float = 0.7,
                direction=None):
    """Planar crop to a fixed-size partial view: keep the ``keep_ratio``
    fraction of points with the largest projection onto a random unit
    direction (the RPM-Net-style partial-overlap corruption behind the
    reference CLI's --partial flag, rpm/arguments.py:55-61). Keeping a fixed
    count (not a half-space test) preserves static shapes for batching.

    Returns (cropped points (K, 3), kept indices (K,), direction (3,))."""
    pts = np.asarray(points, np.float32)
    if direction is None:
        direction = rng.standard_normal(3)
        direction = direction / np.linalg.norm(direction)
    direction = np.asarray(direction, np.float64)
    k = max(1, int(round(pts.shape[0] * keep_ratio)))
    proj = pts.astype(np.float64) @ direction
    idx = np.argsort(-proj, kind="stable")[:k]
    idx = np.sort(idx)  # preserve original point order
    return pts[idx], idx, direction.astype(np.float32)


def random_transform_se3(points, rng: np.random.Generator, mag: float = 1.0,
                         mag_randomly: bool = False):
    """The reference's RandomTransformSE3 (transforms.py:151-193): perturb a
    cloud by exp of a random twist. Returns (p1, gt, igt) where
    igt = exp(x): p0 -> p1 and gt = exp(-x): p1 -> p0."""
    x = random_twist(rng, mag, mag_randomly)
    igt = _se3_exp(x)
    gt = _se3_exp(-x)
    return transform_points(igt, points), gt, igt
