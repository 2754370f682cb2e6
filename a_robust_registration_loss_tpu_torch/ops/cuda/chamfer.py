"""The chamfer distance: the kernel ``csrc/chamfer.cu``, routed by device.

``chamfer_distance(points_x, points_y, per_sample)`` is the mean over the
concatenation of both directions' nearest squared distances of (B, M, 3)
and (B, N, 3) clouds. A CPU tensor runs the plain version
(``ops/geometry.py:chamfer_distance_reference``); a CUDA tensor launches
the kernel, once a call for both directions of all B pairs, or raises.
The kernel writes the minima into one buffer in the order the plain
version's ``torch.cat`` gives them, (B, M + N) per sample or the flat x
minima then y minima over the batch, and the same ``.mean()`` reduces it.
It allocates no (B, M, N) matrix.

Replaces no TPU kernel: the JAX package's chamfer distance is XLA's. It is
here because the plain version's matrix, written and read back by a chain
of ATen kernels, took 0.75 to 1.1 ms of the classical step's 2.82 ms at (1, 8,192,
8,192). The kernel has no backward: every caller passes detached inputs or
runs under ``torch.no_grad``, and an input that requires grad while grad
mode is on raises.

Bound on the H100: operations, ``OPS_PER_PAIR`` a (query, point) pair of
either direction; ``chip_smoke.py`` reports it beside the measured time.
``plan`` picks the split of the other cloud over a cluster of blocks from
the shapes and the SM count.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops.cuda import _build

THREADS = 256        # a block's threads, its queries, and the points of a shared tile
MAX_SPLIT = 8        # blocks of a cluster over the other cloud, fixed in the .cu
OPS_PER_PAIR = 8     # 3 multiplies, 4 adds, the minimum

launches = _build.launch_counter("chamfer")  # key "kernel"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, M: int, N: int, sms: int) -> int:
    """Blocks over the other cloud for (B, M, 3) and (B, N, 3) clouds on
    ``sms`` SMs: the least power-of-two split that gives about two blocks
    an SM (15/8 of the SMs), at most ``MAX_SPLIT``; one block an SM leaves
    the card waiting on latency. Measured on the H100 at the callers'
    shapes (``PERF.md``)."""
    tiles = B * (_cdiv(M, THREADS) + _cdiv(N, THREADS))
    split = 1
    while split < MAX_SPLIT and 8 * tiles * split < 15 * sms:
        split *= 2
    return split


def _check(x, y):
    """Raise on what the kernel does not take."""
    for name, p in (("points_x", x), ("points_y", y)):
        if p.dim() != 3 or p.shape[-1] != 3:
            raise ValueError(f"chamfer_distance: {name} must be (B, n, 3), got {tuple(p.shape)}")
        if p.dtype != torch.float32:
            raise ValueError(f"chamfer_distance: {name} must be float32 on the card, got {p.dtype}")
    if x.device != y.device:
        raise ValueError(f"chamfer_distance: clouds on {x.device} and {y.device}")
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"chamfer_distance: batches {x.shape[0]} and {y.shape[0]}")
    B, M, N = x.shape[0], x.shape[1], y.shape[1]
    if B == 0 or M == 0 or N == 0:
        raise ValueError(f"chamfer_distance: empty clouds {tuple(x.shape)}, {tuple(y.shape)}")
    if B > 65535 or 3 * max(M, N) >= 2**31:
        raise ValueError(f"chamfer_distance: clouds too large, {tuple(x.shape)}, {tuple(y.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise ValueError("chamfer_distance: the kernel has no backward; pass detached clouds "
                         "or call it under torch.no_grad()")


def nearest(points_x, points_y, per_sample: bool = False):
    """Both directions' nearest squared distances of CUDA clouds, in one
    launch: (B, M + N), each row x's minima then y's, with ``per_sample``;
    else (B * (M + N),), every x minimum then every y minimum."""
    _check(points_x, points_y)
    x, y = points_x.contiguous(), points_y.contiguous()
    B, M, N = x.shape[0], x.shape[1], y.shape[1]
    if per_sample:
        out = torch.empty((B, M + N), dtype=torch.float32, device=x.device)
        layout = (M + N, 0, M + N, M)
    else:
        out = torch.empty((B * (M + N),), dtype=torch.float32, device=x.device)
        layout = (M, 0, N, B * M)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rc = _build.library().arrl_chamfer(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), B, M, N, plan(B, M, N, sms), *layout,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "arrl_chamfer")
    launches["kernel"] += 1
    return out


def chamfer_distance(points_x, points_y, per_sample: bool = False):
    """points_x (B, M, 3), points_y (B, N, 3) -> a scalar, or (B,) with
    ``per_sample``; see the module's note."""
    devices = {points_x.device.type, points_y.device.type}
    if devices == {"cpu"}:
        return G.chamfer_distance_reference(points_x, points_y, per_sample)
    if devices != {"cuda"}:
        raise ValueError(f"chamfer_distance: clouds on {points_x.device} and {points_y.device}")
    out = nearest(points_x, points_y, per_sample)
    return out.mean(-1) if per_sample else out.mean()


def operations(B: int, M: int, N: int) -> int:
    """fp32 operations of one call: both directions' pairs."""
    return OPS_PER_PAIR * 2 * B * M * N


def nbytes(B: int, M: int, N: int) -> int:
    """Bytes one call needs to move: the clouds read once, the minima
    written once."""
    return 12 * B * (M + N) + 4 * B * (M + N)
