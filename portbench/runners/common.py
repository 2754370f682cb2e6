"""What the runners share: the program's memory freed before the reference
runs, the numbers compared and their limits, a sample drawn from the
seed."""

from __future__ import annotations

import gc

import numpy as np
import torch

STREAM_CHECK = 2  # the seed's stream that picks what the reference checks
DEVICE = "cuda"   # the card; the CPU tests rehearse a run with "cpu"


def on_card() -> bool:
    return DEVICE == "cuda"


def sync():
    if on_card():
        torch.cuda.synchronize()


def reset_peak():
    if on_card():
        torch.cuda.reset_peak_memory_stats()


def peak() -> int:
    """The most device memory the caching allocator has held since the last
    ``reset_peak``: reserved, not allocated, so that the private pools of
    the CUDA graphs, which replays use without allocating, are counted."""
    return torch.cuda.max_memory_reserved() if on_card() else 0


def free():
    """Let the program's state go before the reference runs on the card."""
    gc.collect()
    if on_card():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sample(seed: int, n: int, k: int):
    """k of range(n), drawn from the seed, in ascending order."""
    rng = np.random.default_rng((seed % 2**64, STREAM_CHECK))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|, with a NaN or an infinity on either side a gap of inf."""
    if not (np.isfinite(a) and np.isfinite(b)):
        return float("inf")
    return abs(a - b) / max(abs(b), 1e-30)


def checks(values: dict, limits: dict):
    """{name: {"value": v, "limit": l}} for every limit, in the limits'
    order; a number the run could not read counts as inf."""
    return {k: {"value": float(values.get(k, float("inf"))), "limit": float(lim)}
            for k, lim in limits.items()}


def launches():
    """The program's own launch counters of its two kernels, by the name
    their kernels carry in a trace (a graph's replays counted)."""
    from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
    from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS

    return {"stage1_kernel": sum(IK.launches.values()),
            "resample_kernel": sum(RS.launches.values())}
