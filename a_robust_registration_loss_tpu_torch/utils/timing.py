"""Step timing and profiler traces.

Port of ``a_robust_registration_loss_tpu/utils/timing.py``: a step timer
that waits for the device before it reads the clock, so that it times the
work and not its queueing, and a ``torch.profiler`` trace scope for deeper
looks.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _cuda_devices(x):
    """The CUDA devices of the tensors in x (nested lists, tuples and dicts
    too)."""
    if isinstance(x, torch.Tensor):
        return {x.device} if x.is_cuda else set()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return set().union(*(_cuda_devices(y) for y in x)) if x else set()
    return set()


class StepTimer:
    """Accumulates device-synchronised step times; ``summary()`` gives
    mean / p50 / p90 over the recorded window (the first ``warmup`` steps
    dropped: they hold the kernels' build and the first launches)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []

    @contextlib.contextmanager
    def step(self, sync_on=None):
        """Times the block. Where ``sync_on`` holds CUDA tensors, the clock
        is read after ``torch.cuda.synchronize()`` of their devices; on the
        CPU there is nothing to wait for."""
        t0 = time.perf_counter()
        yield
        for device in _cuda_devices(sync_on):
            torch.cuda.synchronize(device)
        self.times.append(time.perf_counter() - t0)

    def summary(self):
        ts = sorted(self.times[self.warmup:]) or sorted(self.times)
        if not ts:
            return {}
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(n - 1, int(n * 0.9))],
            "iters_per_sec": n / sum(ts),
        }


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """A ``torch.profiler`` scope (the CPU, and the card where there is
    one) that writes a Chrome trace, ``trace_<pid>_<time>.json``, into
    ``logdir``; a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
