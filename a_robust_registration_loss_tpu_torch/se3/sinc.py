"""Cardinal-sine family with NaN-safe small-angle Taylor branches.

Port of ``a_robust_registration_loss_tpu/se3/sinc.py``. The "double-where"
idiom keeps both branches finite for value and gradient, so plain autograd
is exact everywhere, t == 0 included: the exact branch is evaluated at a
safe t inside the small region, and the Taylor polynomial is finite
everywhere. Threshold |t| < 0.01 and the O(t^8) polynomials are the
reference's.
"""

from __future__ import annotations

import torch

_SMALL = 0.01


def _branch(t, small_fn, exact_fn, safe: float = 1.0):
    """where(|t| < eps, taylor(t), exact(t)), safe for value and grad."""
    small = t.abs() < _SMALL
    t_safe = torch.where(small, torch.full_like(t, safe), t)
    return torch.where(small, small_fn(t), exact_fn(t_safe))


def sinc1(t):
    """sin(t)/t."""
    return _branch(
        t,
        lambda t: 1 - t**2 / 6 * (1 - t**2 / 20 * (1 - t**2 / 42)),
        lambda t: torch.sin(t) / t,
    )


def sinc1_dt(t):
    """d/dt sin(t)/t."""
    return _branch(
        t,
        lambda t: -t / 3 * (1 - t**2 / 10 * (1 - t**2 / 28 * (1 - t**2 / 54))),
        lambda t: torch.cos(t) / t - torch.sin(t) / t**2,
    )


def rsinc1(t):
    """t/sin(t)."""
    return _branch(
        t,
        lambda t: (((31 * t**2) / 42 + 7) * t**2 / 60 + 1) * t**2 / 6 + 1,
        lambda t: t / torch.sin(t),
    )


def sinc2(t):
    """(1 - cos(t))/t**2."""
    return _branch(
        t,
        lambda t: 0.5 * (1 - t**2 / 12 * (1 - t**2 / 30 * (1 - t**2 / 56))),
        lambda t: (1 - torch.cos(t)) / t**2,
    )


def sinc2_dt(t):
    """d/dt sinc2."""
    return _branch(
        t,
        lambda t: -t / 12 * (1 - t**2 / 5 * (1.0 / 3 - t**2 / 56 * (0.5 - t**2 / 135))),
        lambda t: torch.sin(t) / t**2 - 2 * (1 - torch.cos(t)) / t**3,
    )


def sinc3(t):
    """(t - sin(t))/t**3."""
    return _branch(
        t,
        lambda t: 1 / 6 * (1 - t**2 / 20 * (1 - t**2 / 42 * (1 - t**2 / 72))),
        lambda t: (t - torch.sin(t)) / t**3,
    )


def sinc3_dt(t):
    """d/dt sinc3."""
    return _branch(
        t,
        lambda t: -t / 60 * (1 - t**2 / 21 * (1 - t**2 / 24 * (0.5 - t**2 / 165))),
        lambda t: (3 * torch.sin(t) - t * (torch.cos(t) + 2)) / t**4,
    )
