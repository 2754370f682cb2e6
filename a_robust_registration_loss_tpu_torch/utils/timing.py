"""Step timing, profiler traces and the program's spans.

Port of ``a_robust_registration_loss_tpu/utils/timing.py``: a step timer
that waits for the device before it reads the clock, so that it times the
work and not its queueing, and a ``torch.profiler`` trace scope for deeper
looks.

Spans: ``span(name)`` marks a part of the program as a ``torch.profiler``
range, on the profiler's own clock beside the operators, the CUDA calls and
the device's operations. With no profiler running it is one flag check and
records nothing. The spans, ``SPANS``, nest on the host thread; a request's
or an epoch's parts lie inside its root:

- ``arrl.classical.run`` (root): a ``train/classical.py`` ``run`` or
  ``run_batch`` call; inside it ``arrl.classical.prepare`` (FPS and 3-NN of
  both clouds, centring, the sphere), ``arrl.classical.block`` (a block of
  ``log_every`` epochs; the first holds ``arrl.classical.capture``, the
  first epoch's eager step and the graph's capture),
  ``arrl.classical.fetch`` (a block's metrics to the host, the callback)
  and ``arrl.classical.release`` (the graph and its memory pool freed);
- ``arrl.fit.epoch`` (root): an epoch of ``train/harness.py``
  ``Trainer.fit``; inside it ``arrl.fit.train`` and ``arrl.fit.eval`` (the
  passes with their fetches) and ``arrl.fit.checkpoint`` (the save on the
  loop's thread: the wait for the previous commit, the device-to-host
  copy); inside a pass, a split step's parts: ``arrl.step.forward``
  (each piece, captured or eager), ``arrl.step.solve`` (each solve between
  two pieces: the SVDs of DCP and RPM-Net), and in a train step
  ``arrl.step.backward`` (the gradient) and ``arrl.step.update`` (Adam).

``with utils.trace(logdir): ...`` around a ``classical.run`` or a
``Trainer.fit`` writes them into its Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

SPANS = ("arrl.classical.run", "arrl.classical.prepare", "arrl.classical.block",
         "arrl.classical.capture", "arrl.classical.fetch", "arrl.classical.release",
         "arrl.fit.epoch", "arrl.fit.train", "arrl.fit.eval", "arrl.fit.checkpoint",
         "arrl.step.forward", "arrl.step.solve", "arrl.step.backward", "arrl.step.update")

_OFF = contextlib.nullcontext()  # every span of a run with no profiler


def span(name: str):
    """``with span(name): ...``: the block as a ``torch.profiler`` range
    named ``name`` (one of ``SPANS``) while a profiler runs; otherwise one
    shared no-op, after a single flag check.

    The range is a function-scope one, as an operator's, not
    ``record_function``'s user annotation: the profiler mirrors a user
    annotation on the device as an event over the kernels launched inside
    it, which a reading of the trace would count as device work."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


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
