"""Row gather with a gradient: the kernels of ``csrc/gather.cu`` and their
plain PyTorch versions.

``gather_rows(table, idx)[b, q, :] = table[b, idx[b, q], :]`` for table
(B, N, C) float32 and idx (B, Q) int32 or int64; the gradient with respect
to the table is the scatter-add of the upstream rows, and idx takes none.
Replaces the TPU kernels ``a_robust_registration_loss_tpu/ops/pallas/
gather.py:_fwd_kernel`` and ``_bwd_kernel`` behind ``gather_rows``. No model
calls it (none does in the JAX package either, which kept it for wide C):
it is an op with its own entry point.

Out-of-range indices follow the TPU kernel's one-hot selector: a row whose
idx is < 0 or >= N comes out as zeros, and its gradient is dropped.
``torch.take_along_dim`` would raise or read out of bounds there, and
``jnp.take_along_axis`` would clamp.

The forward is a copy and equals ``torch.take_along_dim`` bit for bit for
in-range idx. The backward kernel is deterministic: every (row, column) sum
is taken by one thread in ascending q from 0, the order of ``index_add_`` on
the CPU, so it equals the plain version on the CPU bit for bit and two
launches give equal bits. The plain version on the card sums with atomics in
an order of its own, so against it the kernel is held to 1e-6 * sum_q |g|.

Bound on the H100: bytes, 4 * (B*N*C + B*Q + B*Q*C) each way over 3.35
TB/s; ``chip_smoke.py`` reports it beside the measured times.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch.ops.cuda import _build

launches = {"fwd": 0, "bwd": 0}  # kernel launches since the last reset


def _in_range(idx, n_rows: int):
    idx = idx.long()
    return idx, (idx >= 0) & (idx < n_rows)


def gather_rows_reference(table, idx):
    """Plain PyTorch version of the forward kernel."""
    N = table.shape[1]
    if N == 0:
        return table.new_zeros((*idx.shape, table.shape[2]))
    idx, ok = _in_range(idx, N)
    out = torch.take_along_dim(table, idx.clamp(0, N - 1)[..., None], 1)
    return torch.where(ok[..., None], out, 0.0)


def gather_rows_bwd_reference(g, idx, n_rows: int):
    """Plain PyTorch version of the backward kernel: g (B, Q, C) added onto
    a zero (B, n_rows, C) table at idx, one ``index_add_`` over the flat
    table; out-of-range rows go to a dump row that is cut off."""
    B, Q, C = g.shape
    idx, ok = _in_range(idx, n_rows)
    rows = torch.arange(B, device=g.device)[:, None] * n_rows + idx
    flat = torch.where(ok, rows, B * n_rows).reshape(-1)
    out = g.new_zeros((B * n_rows + 1, C))
    out.index_add_(0, flat, g.reshape(B * Q, C))
    return out[:B * n_rows].reshape(B, n_rows, C)


def _check(name, table_like, idx):
    """Shapes, types and the kernels' index limits; returns contiguous
    (table_like, idx)."""
    if table_like.dim() != 3 or idx.dim() != 2 or idx.shape[0] != table_like.shape[0]:
        raise ValueError(f"{name}: need (B, ., C) and idx (B, Q), got "
                         f"{tuple(table_like.shape)} and {tuple(idx.shape)}")
    if table_like.dtype != torch.float32:
        raise ValueError(f"{name}: need float32, got {table_like.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: idx must be int32 or int64, got {idx.dtype}")
    if idx.device != table_like.device:
        raise ValueError(f"{name}: idx on {idx.device}, values on {table_like.device}")
    return table_like.contiguous(), idx.contiguous()


def _check_limits(name, B, N, C, Q):
    if B > 65535 or Q * max(C, 1) >= 2**31 - 4096 or N >= 2**31 - 64:
        raise ValueError(f"{name}: B={B} N={N} C={C} Q={Q} beyond the kernel's "
                         "index range (B <= 65535, Q * C < 2^31)")


def gather_rows_fwd(table, idx):
    """The forward alone (no autograd): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    table, idx = _check("gather_rows", table, idx)
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    (B, N, C), Q = table.shape, idx.shape[1]
    _check_limits("gather_rows", B, N, C, Q)
    if B * Q * C == 0 or N == 0:
        return table.new_zeros((B, Q, C))
    out = torch.empty((B, Q, C), dtype=torch.float32, device=table.device)
    rc = _build.library().arrl_gather_fwd(
        table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        out.data_ptr(), B, N, C, Q, torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(rc, "arrl_gather_fwd")
    launches["fwd"] += 1
    return out


def gather_rows_bwd(g, idx, n_rows: int):
    """The backward alone: g (B, Q, C), idx (B, Q) -> (B, n_rows, C)."""
    g, idx = _check("gather_rows backward", g, idx)
    if g.shape[1] != idx.shape[1]:
        raise ValueError(f"gather_rows backward: g {tuple(g.shape)} against idx "
                         f"{tuple(idx.shape)}")
    if g.device.type == "cpu":
        return gather_rows_bwd_reference(g, idx, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"gather_rows backward: unsupported device {g.device}")
    B, Q, C = g.shape
    _check_limits("gather_rows backward", B, n_rows, C, Q)
    if B * n_rows * C == 0 or Q == 0:
        return g.new_zeros((B, n_rows, C))
    dtab = torch.empty((B, n_rows, C), dtype=torch.float32, device=g.device)
    rc = _build.library().arrl_gather_bwd(
        g.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        dtab.data_ptr(), B, n_rows, C, Q, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "arrl_gather_bwd")
    launches["bwd"] += 1
    return dtab


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[1]
        return gather_rows_fwd(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows_bwd(g, idx, ctx.n_rows), None


def gather_rows(table, idx):
    """``table[b, idx[b, q], :]``: table (B, N, C) float32, idx (B, Q) int32
    or int64 -> (B, Q, C), differentiable in the table. Rows with idx
    outside [0, N) are zeros and take no gradient. CUDA tensors launch the
    kernels (or raise); CPU tensors run the plain versions."""
    return _GatherRows.apply(table, idx)
