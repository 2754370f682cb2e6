"""Shared fixtures of the ``test_torch_*`` files: the PyTorch port checked
against the JAX package on the same numpy inputs.

JAX stays on the CPU (conftest pins it); data crosses between the two as
numpy arrays. The tests that need a CUDA card are in test_torch_cuda.py,
which imports no JAX.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import geometry as JG
from a_robust_registration_loss_tpu.ops import lines as JL


def sphere_cloud(n, rng, noise=0.0):
    """Fibonacci unit sphere (n, 3) float32, plus optional Gaussian noise."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    pts = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                    np.cos(phi)], -1).astype(np.float32)
    if noise:
        pts = pts + rng.standard_normal(pts.shape).astype(np.float32) * noise
    return pts


def neighs(pts, num_sample):
    """The JAX package's FPS + 3-NN neighbourhoods, (num_sample, 9)."""
    return np.asarray(JG.sample_neighs(jnp.asarray(pts), num_sample=num_sample,
                                       num_neigh=3)).reshape(num_sample, 9)


def random_problem(seed=7, f1=333, f2=301, n_lines=257):
    """Two noisy sphere clouds' neighbourhoods and a JAX-resampled line set;
    F and L deliberately not multiples of any tile size (the pattern of
    tests/test_pallas.py)."""
    rng = np.random.default_rng(seed)
    pts1 = sphere_cloud(400, rng, noise=0.01)
    pts2 = sphere_cloud(410, rng, noise=0.01)
    lines = np.asarray(JL.resample_lines(
        jax.random.PRNGKey(3), jnp.float32(3.0), jnp.zeros(3, jnp.float32),
        n_lines, jnp.asarray(pts1), jnp.asarray(pts2)))
    return neighs(pts1, f1), neighs(pts2, f2), lines


def t(x, device="cpu"):
    """numpy -> torch tensor (a copy, so the test owns it)."""
    return torch.tensor(np.asarray(x), device=device)


def make_batch(B=2, N=48, F=24, seed=0, rot=0.25):
    """A synthetic batch in the dataset dict's contract, DCP form (column
    convention R), as numpy arrays: noisy Fibonacci spheres, a known
    rotation about z and a translation, FPS + 3-NN neighbourhood buffers
    (B, F * 3, 3) and the target's bbox corners from the JAX package.
    ``chip_smoke.py:dcp_batch`` makes the same batch with the port's own
    functions."""
    rng = np.random.default_rng(seed)
    src = np.stack([sphere_cloud(N, rng, noise=0.01) for _ in range(B)])
    R = np.array([[np.cos(rot), -np.sin(rot), 0],
                  [np.sin(rot), np.cos(rot), 0], [0, 0, 1]], np.float32)
    T = np.asarray([0.05, -0.02, 0.01], np.float32)
    tar = src @ R + T
    tar = tar - tar.mean(1, keepdims=True)
    src = src - src.mean(1, keepdims=True)
    return {
        "points_src_sample": src, "points_tar_sample": tar,
        "points_based_neighs_src": np.stack([neighs(s, F).reshape(-1, 3) for s in src]),
        "points_based_neighs_tar": np.stack([neighs(x, F).reshape(-1, 3) for x in tar]),
        "tar_box": np.array(JG.bounding_box_corners(jnp.asarray(tar))),
        "centers": tar.mean(1),
        # column convention: tar = R^T src + T (before centring)
        "R": np.stack([R.T] * B), "T": np.stack([T] * B),
        "R_inv": np.stack([R] * B), "T_inv": np.stack([-R @ T] * B),
    }


def flax_params_numpy(params):
    """A flax parameter tree -> the same tree of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, params)


def jax_uniforms(key, batch, n_lines, rounds=10):
    """The uniforms ``batch_lines`` of the JAX package draws from ``key``:
    (B, 4, rounds * n_lines)."""
    return np.stack([np.asarray(jax.random.uniform(k, (4, rounds * n_lines)))
                     for k in jax.random.split(key, batch)])


def perturbed(params, seed, scale=0.1):
    """A flax parameter tree as numpy arrays, each leaf plus seeded Gaussian
    noise: biases and norm scales leave their trivial initial values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(p.shape).astype(np.float32),
        params)
