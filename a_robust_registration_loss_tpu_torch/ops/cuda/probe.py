"""Probe of the card's achievable fp32 rate: the kernel ``csrc/probe.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``bench.py:measured_vpu_peak`` (its ``kern``), the
JAX package's probe of the vector unit. Each element of x carries
``CHAINS`` = 4 independent values x * (0.1 + 0.2 c) through
``iters * UNROLL`` steps of the logistic map x <- (r * x) * (1 - x),
r = x[0] * 3.9 read at run time, and the chains' sum is written out: 3 fp32
operations per element-iteration, no memory traffic in the loop, no fused
multiply-add.

``measured_fp32_rate`` times the kernel at ``bench.py``'s shape (``N`` =
1,048,576 elements, ``ITERS`` = 512 x 16 steps, 4 chains) and returns
operations per second: the denominator of the operation bounds of the
port's kernels, which are all built without FMA. The data sheet's
67 TFLOP/s counts an FMA as two operations and is out of their reach.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.ops.cuda import _build

UNROLL = 16         # steps per loop iteration, fixed in the .cu
CHAINS = 4          # independent values per element, fixed in the .cu
OPS_PER_STEP = 3    # r * x, 1 - x, and their product
N, ITERS, REPS = 8 * 128 * 1024, 512, 10  # the measurement: bench.py's shape

launches = _build.launch_counter("probe")  # key "kernel"


def logistic_map_reference(x, iters: int):
    """Plain PyTorch version of the kernel, same order of operations."""
    r = x[0] * 3.9
    xs = [x * (0.1 + 0.2 * c) for c in range(CHAINS)]
    for _ in range(iters * UNROLL):
        xs = [(r * v) * (1.0 - v) for v in xs]
    acc = xs[0]
    for v in xs[1:]:
        acc = acc + v
    return acc


def logistic_map(x, iters: int):
    """x (n,) float32 -> (n,): the chains' sum after iters * UNROLL steps.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    if x.device.type == "cpu":
        return logistic_map_reference(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"logistic_map: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or x.shape[0] == 0:
        raise ValueError("logistic_map: x must be a non-empty (n,) float32 tensor")
    if iters < 0:
        raise ValueError("logistic_map: iters must be >= 0")
    x = x.contiguous()
    out = torch.empty_like(x)
    rc = _build.library().arrl_logistic(
        x.data_ptr(), out.data_ptr(), x.shape[0], iters,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "arrl_logistic")
    launches["kernel"] += 1
    return out


def operations(n: int, iters: int) -> int:
    """fp32 operations of one call on n elements."""
    return OPS_PER_STEP * iters * UNROLL * CHAINS * n


def measured_fp32_rate(device=None):
    """Achieved fp32 operations per second of the kernel on the card, and
    its ms per call (CUDA events over ``REPS`` calls after a warm-up) on
    ``N`` elements at ``ITERS``. x is all ones, as in ``bench.py``. Raises
    without a card: the rate of a CPU is not the card's."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"measured_fp32_rate: measures a CUDA device, not {dev}")
    x = torch.ones(N, dtype=torch.float32, device=dev)
    logistic_map(x, ITERS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        logistic_map(x, ITERS)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / REPS
    return operations(N, ITERS) / (ms / 1e3), ms
