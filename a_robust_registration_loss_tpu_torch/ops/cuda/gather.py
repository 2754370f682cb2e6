"""Row gather with a gradient: the kernels of ``csrc/gather.cu`` and their
plain PyTorch versions.

``gather_rows(table, idx)[b, q, :] = table[b, idx[b, q], :]`` for table
(B, N, C) float32 and idx (B, Q) int32 or int64; the gradient with respect
to the table is the scatter-add of the upstream rows, and idx takes none.
Replaces the TPU kernels ``a_robust_registration_loss_tpu/ops/pallas/
gather.py:_fwd_kernel`` and ``_bwd_kernel`` behind ``gather_rows``.
RPM-Net's grouping calls it (``models/rpmnet.py:_group_gather``: the
neighbours' xyz and normals, C = 6, at (4, 1,024, 6, 65,536) at the
default width), where the JAX package takes ``jnp.take`` for the same
function. The grouped table there is data, so only the forward runs on
that path.

Out-of-range indices follow the TPU kernel's one-hot selector: a row whose
idx is < 0 or >= N comes out as zeros, and its gradient is dropped.
``torch.take_along_dim`` would raise or read out of bounds there, and
``jnp.take_along_axis`` would clamp.

The forward is a copy and equals ``torch.take_along_dim`` bit for bit for
in-range idx: one launch, one thread per float4 where C is a multiple of 4
and the table is 16-byte aligned, else a warp per run of 32 query rows. The backward is deterministic: every (row, column) sum is
taken by one lane in ascending q from 0, the order of ``index_add_`` on the
CPU, so it equals the plain version on the CPU bit for bit and two launches
give equal bits. The plain version on the card sums with atomics in an order
of its own, so against it the kernels are held to 1e-6 * sum_q |g|.

The backward is three kernels per call (``csrc/gather.cu``): a histogram
of the rows over G chunks of a sample's queries, a stable counting sort
that writes ``start`` (B, N + 1) and ``perm`` (B, Q), the queries grouped by
row in ascending q with the dropped ones as the tail, and a segmented sum
with one group of lanes per table row and several g rows in flight.
``sort_by_row_reference`` and ``segmented_sum_reference`` are the plain
versions of the two stages; together they equal
``gather_rows_bwd_reference`` bit for bit on the CPU. The wrapper allocates
the scratch and picks G and the sort's warps per block from the shape alone
(``_sort_plan``).

Bound on the H100: bytes, 4 * (B*N*C + B*Q + B*Q*C) each way over 3.35
TB/s; ``chip_smoke.py`` reports it beside the measured times. At this
system's shapes (a few thousand rows, C of 3 to 6) that bound lies under
the time of one launch, and the library call ``index_add_`` is the
yardstick.
"""

from __future__ import annotations

import torch

from a_robust_registration_loss_tpu_torch.ops.cuda import _build

# wrapper calls that launched since the last reset: the forward (one kernel a
# call) and the backward's two stages, the sort (two kernels a call) and the
# sum (one); a backward is one call of each
launches = {"fwd": 0, "bwd_sort": 0, "bwd_sum": 0}
BWD_KERNELS = 3  # kernels a backward launches
SORT_SHARED_INTS = (227 * 1024 - 256) // 4  # a block's shared memory, less the static part
SORT_MAX_WARPS = 16
SORT_MAX_BLOCKS = 16   # blocks a sample's queries are split over
SORT_WARP_QUERIES = 64  # queries a warp of the sort should have at least


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


def sort_by_row_reference(idx, n_rows: int):
    """Plain PyTorch version of the backward's sort: idx (B, Q) -> (start
    (B, n_rows + 1) int32, perm (B, Q) int32). perm[b] lists the queries
    grouped by row, ascending q inside a row, row n's at
    perm[b, start[b, n] : start[b, n + 1]]; the queries with idx outside
    [0, n_rows) follow from start[b, n_rows], ascending too."""
    idx, ok = _in_range(idx, n_rows)
    key = torch.where(ok, idx, n_rows)
    perm = torch.argsort(key, dim=1, stable=True)
    ones = torch.ones_like(key)
    counts = torch.zeros((idx.shape[0], n_rows + 1), dtype=torch.long,
                         device=idx.device).scatter_add_(1, key, ones)
    start = torch.cumsum(counts, 1) - counts
    return start.int(), perm.int()


def segmented_sum_reference(g, start, perm):
    """Plain PyTorch version of the backward's sum: g (B, Q, C) and the
    sort's (start, perm) -> (B, N, C), row n the sum of g[b, perm[b, s]]
    over s in [start[b, n], start[b, n + 1]) taken in that order from 0:
    step k adds every row's k-th query."""
    B, Q, C = g.shape
    N = start.shape[1] - 1
    lo, hi = start[:, :-1].long(), start[:, 1:].long()
    out = g.new_zeros((B, N, C))
    batch = torch.arange(B, device=g.device)[:, None].expand(B, N)
    for k in range(int((hi - lo).max()) if B * N else 0):
        live = lo + k < hi
        q = torch.gather(perm.long(), 1, (lo + k).clamp_max(max(Q - 1, 0)))
        out[live] = out[live] + g[batch[live], q[live]]
    return out


def _sort_plan(n_rows: int, n_queries: int):
    """(G, W) of the backward's sort: G blocks a sample, W warps a block.
    A warp keeps a counter per row (and the dump row) in shared memory, so W
    is what fits beside the two row arrays of the scan; G gives every warp
    SORT_WARP_QUERIES queries or more, up to SORT_MAX_BLOCKS."""
    W = min(SORT_MAX_WARPS, SORT_SHARED_INTS // (n_rows + 1) - 2)
    if W < 1:
        raise ValueError(f"gather_rows backward: {n_rows} table rows are more than the "
                         f"sort's counters hold ({SORT_SHARED_INTS // 3 - 1})")
    G = -(-n_queries // (SORT_WARP_QUERIES * W))
    return max(1, min(SORT_MAX_BLOCKS, G)), W


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


def sort_by_row(idx, n_rows: int):
    """The backward's sort: idx (B, Q) int32 or int64 -> (start (B, n_rows +
    1), perm (B, Q)) int32 as ``sort_by_row_reference`` gives them; two
    kernels on a CUDA tensor (or raises), the plain version on the CPU."""
    if idx.dim() != 2 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"sort_by_row: idx must be (B, Q) int32 or int64, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device.type == "cpu":
        return sort_by_row_reference(idx, n_rows)
    if idx.device.type != "cuda":
        raise ValueError(f"sort_by_row: unsupported device {idx.device}")
    idx = idx.contiguous()
    B, Q = idx.shape
    _check_limits("sort_by_row", B, n_rows, 1, Q)
    G, W = _sort_plan(n_rows, Q)
    i32 = dict(dtype=torch.int32, device=idx.device)
    counts = torch.empty((B, G, n_rows + 1), **i32)
    start = torch.empty((B, n_rows + 1), **i32)
    perm = torch.empty((B, Q), **i32)
    if B == 0:
        return start, perm
    rc = _build.library().arrl_gather_sort(
        idx.data_ptr(), int(idx.dtype == torch.int64), counts.data_ptr(), start.data_ptr(),
        perm.data_ptr(), B, n_rows, Q, G, W, torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check(rc, "arrl_gather_sort")
    launches["bwd_sort"] += 1
    return start, perm


def segmented_sum(g, start, perm):
    """The backward's sum: g (B, Q, C) float32 and the sort's (start, perm)
    -> (B, N, C) as ``segmented_sum_reference`` gives it; one kernel on CUDA
    tensors (or raises), the plain version on the CPU."""
    B, Q, C = g.shape
    N = start.shape[1] - 1
    for name, x, shape in (("start", start, (B, N + 1)), ("perm", perm, (B, Q))):
        if x.dtype != torch.int32 or x.device != g.device or tuple(x.shape) != shape:
            raise ValueError(f"segmented_sum: {name} must be int32 {shape} on {g.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if g.dtype != torch.float32:
        raise ValueError(f"segmented_sum: need float32, got {g.dtype}")
    if g.device.type == "cpu":
        return segmented_sum_reference(g, start, perm)
    if g.device.type != "cuda":
        raise ValueError(f"segmented_sum: unsupported device {g.device}")
    _check_limits("segmented_sum", B, N, C, Q)
    g, start, perm = g.contiguous(), start.contiguous(), perm.contiguous()
    dtab = torch.empty((B, N, C), dtype=torch.float32, device=g.device)
    if B * N * C == 0:
        return dtab
    rc = _build.library().arrl_gather_segsum(
        g.data_ptr(), start.data_ptr(), perm.data_ptr(), dtab.data_ptr(), B, N, C, Q,
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "arrl_gather_segsum")
    launches["bwd_sum"] += 1
    return dtab


def gather_rows_bwd(g, idx, n_rows: int):
    """The backward alone: g (B, Q, C), idx (B, Q) -> (B, n_rows, C). On
    CUDA tensors the sort and the sum, three kernels (or raises); on CPU
    tensors the plain version."""
    g, idx = _check("gather_rows backward", g, idx)
    if g.shape[1] != idx.shape[1]:
        raise ValueError(f"gather_rows backward: g {tuple(g.shape)} against idx "
                         f"{tuple(idx.shape)}")
    if g.device.type == "cpu":
        return gather_rows_bwd_reference(g, idx, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"gather_rows backward: unsupported device {g.device}")
    return segmented_sum(g, *sort_by_row(idx, n_rows))


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
