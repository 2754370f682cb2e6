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
