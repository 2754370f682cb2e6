"""Farthest-point sampling: the kernel ``csrc/fps.cu``, routed by device.

``farthest_point_sample(xyz, npoint, start_idx)`` picks npoint indices of
each cloud of xyz (B, N, 3) greedily, from ``start_idx`` ((B,), or index 0
where it is None). A CPU tensor runs the plain loop
(``ops/geometry.py:farthest_point_sample_reference``); a CUDA tensor
launches the kernel, once a call for all B clouds, or raises. The kernel
gives the plain loop's indices bit for bit on the card (the note in the
source says how).

Replaces no TPU kernel: the JAX package's FPS is a ``lax.fori_loop`` that
XLA compiles. It is here because the plain loop's 5,000 steps of about 7
launches each, per cloud, are paced by the host.

Bound on the H100: the latency of npoint dependent block-wide argmax
rounds. ``OPS_PER_UPDATE`` fp32 operations a point and pick and the cloud's
bytes are microseconds; ``chip_smoke.py`` reports both beside the measured
time and the kernel's own time at one point (its chain of rounds alone).
Clouds of up to ``ON_CHIP_POINTS`` stay in the block's registers and
shared memory; larger ones stream from global memory, their running minima
in a scratch buffer the wrapper allocates.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops.cuda import _build

ON_CHIP_POINTS = 8192  # 1,024 threads x 8 points, fixed in the .cu
OPS_PER_UPDATE = 10    # 3 subtractions, 3 squares, 2 adds, the minimum, the argmax's compare

launches = _build.launch_counter("fps")  # key "kernel"


def _start(xyz, start_idx):
    """start_idx as a (B,) int64 tensor on xyz's device, or None; raises on
    another shape."""
    if start_idx is None:
        return None
    start = torch.as_tensor(start_idx, device=xyz.device).long()
    if start.shape != xyz.shape[:1]:
        raise ValueError(f"farthest_point_sample: start_idx must be ({xyz.shape[0]},), "
                         f"got {tuple(start.shape)}")
    return start


def farthest_point_sample(xyz, npoint: int, start_idx=None):
    """xyz (B, N, 3) -> (B, npoint) int64 indices; see the module's note."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"farthest_point_sample: xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if npoint < 0:
        raise ValueError(f"farthest_point_sample: npoint must be >= 0, got {npoint}")
    start = _start(xyz, start_idx)
    if xyz.device.type == "cpu":
        return G.farthest_point_sample_reference(xyz, npoint, start)
    if xyz.device.type != "cuda":
        raise ValueError(f"farthest_point_sample: unsupported device {xyz.device}")
    if xyz.dtype != torch.float32 or not xyz.is_contiguous():
        raise ValueError("farthest_point_sample: xyz must be contiguous float32 on the card, "
                         f"got {xyz.dtype}")
    B, N, _ = xyz.shape
    if B == 0 or N == 0:
        raise ValueError(f"farthest_point_sample: empty clouds {tuple(xyz.shape)}")
    if start is not None:
        start = start.contiguous()
    out = torch.empty((B, npoint), dtype=torch.long, device=xyz.device)
    minima = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
              if N > ON_CHIP_POINTS else None)
    rc = _build.library().arrl_fps(
        xyz.data_ptr(), None if start is None else start.data_ptr(), out.data_ptr(),
        None if minima is None else minima.data_ptr(), B, N, npoint,
        torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(rc, "arrl_fps")
    launches["kernel"] += 1
    return out


def operations(B: int, N: int, npoint: int) -> int:
    """fp32 operations of one call."""
    return OPS_PER_UPDATE * B * N * npoint


def nbytes(B: int, N: int, npoint: int) -> int:
    """Bytes one call needs to move: the clouds read once, the indices
    written once."""
    return 12 * B * N + 8 * B * npoint
