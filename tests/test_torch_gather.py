"""The port's row gather (ops/cuda/gather.py) against the JAX package's
``ops/pallas/gather.py`` kernels in interpret mode, on the CPU.

Bars: the forward equals the JAX kernel bit for bit, out-of-range indices
included (zero rows on both sides); the backward through autograd agrees
within rtol 1e-5 / atol 1e-5, the JAX package's own bar for its kernel
against ``take_along_axis`` (the two sum in different orders); the plain
forward equals ``torch.take_along_dim`` bit for bit for in-range idx, and
the plain backward equals a sequential loop in ascending q bit for bit,
which is the order the CUDA kernels promise. The backward's two stages as
the kernels make them, ``sort_by_row_reference`` then
``segmented_sum_reference``, equal the plain backward bit for bit on every
edge case (all queries on one row, most rows empty, indices out of range,
every index out of range, int32 and int64, Q of any length), and the JAX
``gather_rows`` gradient per element within 1e-6 times the sum of |g| over
the queries it adds (the one-hot contraction sums a row's queries in another
order), the bar the card's kernels are held to against ``index_add_``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops.pallas.gather import gather_rows as jax_gather_rows
from a_robust_registration_loss_tpu_torch.ops.cuda import gather as GK
from torch_port_helpers import t

torch.set_num_threads(1)

SHAPES = [(2, 40, 6, 100), (1, 128, 3, 128), (3, 17, 5, 33)]


def _case(shape, out_of_range, dtype=np.int32):
    B, N, C, Q = shape
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((B, N, C)).astype(np.float32)
    lo, hi = (-3, N + 3) if out_of_range else (0, N)
    idx = rng.integers(lo, hi, (B, Q)).astype(dtype)
    g = rng.standard_normal((B, Q, C)).astype(np.float32)
    return tab, idx, g


@pytest.mark.parametrize("out_of_range", [False, True], ids=["in-range", "out-of-range"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_backward_match_jax_kernel(shape, out_of_range):
    tab, idx, g = _case(shape, out_of_range)
    want = jax_gather_rows(jnp.asarray(tab), jnp.asarray(idx), True)
    gwant = jax.grad(lambda x: jnp.sum(jax_gather_rows(x, jnp.asarray(idx), True)
                                       * jnp.asarray(g)))(jnp.asarray(tab))
    table = t(tab).requires_grad_(True)
    out = GK.gather_rows(table, t(idx))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    (grad,) = torch.autograd.grad((out * t(g)).sum(), table)
    np.testing.assert_allclose(grad.numpy(), np.asarray(gwant), rtol=1e-5, atol=1e-5)
    if out_of_range:
        bad = (idx < 0) | (idx >= shape[1])
        assert bad.any() and (out.detach().numpy()[bad] == 0).all()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_versions_exact(dtype):
    """In range the plain forward is take_along_dim; the plain backward is
    the sequential sum in ascending q, out-of-range rows dropped."""
    tab, idx, g = _case((3, 17, 5, 33), True, dtype)
    inside = np.clip(idx, 0, 16)
    np.testing.assert_array_equal(
        GK.gather_rows_reference(t(tab), t(inside)).numpy(),
        torch.take_along_dim(t(tab), t(inside).long()[..., None], 1).numpy())
    want = np.zeros_like(tab)
    for b in range(3):
        for q in range(33):
            if 0 <= idx[b, q] < 17:
                want[b, idx[b, q]] += g[b, q]
    np.testing.assert_array_equal(GK.gather_rows_bwd_reference(t(g), t(idx), 17).numpy(), want)
    np.testing.assert_array_equal(GK.gather_rows_bwd(t(g), t(idx), 17).numpy(), want)


def test_idx_takes_no_gradient_and_empty_shapes():
    tab, idx, _ = _case((2, 40, 6, 100), False)
    table = t(tab).requires_grad_(True)
    out = GK.gather_rows(table, t(idx))
    assert out.requires_grad and out.shape == (2, 100, 6)
    assert GK.gather_rows(t(tab), t(idx[:, :0])).shape == (2, 0, 6)
    assert GK.gather_rows_bwd(torch.zeros((2, 0, 6)), t(idx[:, :0]), 40).abs().sum() == 0


def test_wrapper_refuses_what_the_kernels_cannot_take():
    tab, idx, _ = _case((2, 40, 6, 100), False)
    with pytest.raises(ValueError):  # neither the CPU nor a card: no fallback
        GK.gather_rows(t(tab).to("meta"), t(idx).to("meta"))
    with pytest.raises(ValueError):
        GK.gather_rows_bwd(torch.zeros((2, 100, 6), device="meta"), t(idx).to("meta"), 40)
    with pytest.raises(ValueError):
        GK.gather_rows(t(tab).double(), t(idx))
    with pytest.raises(ValueError):
        GK.gather_rows(t(tab), t(idx).float())
    with pytest.raises(ValueError):
        GK.gather_rows(t(tab), t(idx)[:1])


EDGE_CASES = ["one-row", "sparse-rows", "out-of-range", "all-dropped", "one-query", "odd-length"]


def _edge_case(case, dtype):
    """(g, idx, N) as numpy arrays for the backward's edge cases."""
    rng = np.random.default_rng(5)
    B, N, C, Q = {"one-row": (2, 40, 6, 301), "sparse-rows": (3, 200, 3, 157),
                  "out-of-range": (2, 24, 5, 133), "all-dropped": (1, 9, 4, 70),
                  "one-query": (2, 7, 3, 1), "odd-length": (2, 33, 6, 129)}[case]
    if case == "one-row":
        idx = np.full((B, Q), 17)
    elif case == "sparse-rows":  # 4 of the 200 rows take every query
        idx = np.array([3, 70, 71, 199])[rng.integers(0, 4, (B, Q))]
    elif case == "out-of-range":
        idx = rng.integers(-12, N + 12, (B, Q))
    elif case == "all-dropped":
        idx = np.where(rng.random((B, Q)) < 0.5, -1, N)
    else:
        idx = rng.integers(0, N, (B, Q))
    return rng.standard_normal((B, Q, C)).astype(np.float32), idx.astype(dtype), N


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_sort_then_segmented_sum_is_the_backward(case, dtype):
    g, idx, N = _edge_case(case, dtype)
    start, perm = GK.sort_by_row_reference(t(idx), N)
    assert start.dtype == perm.dtype == torch.int32
    assert start.shape == (idx.shape[0], N + 1) and perm.shape == idx.shape
    for b in range(idx.shape[0]):
        row = np.where((idx[b] >= 0) & (idx[b] < N), idx[b], N)
        # a stable sort by row: the queries of each row ascending, dropped ones last
        want = np.argsort(row, kind="stable")
        np.testing.assert_array_equal(perm[b].numpy(), want)
        np.testing.assert_array_equal(start[b].numpy(),
                                      np.searchsorted(row[want], np.arange(N + 1)))
    got = GK.segmented_sum_reference(t(g), start, perm)
    want = GK.gather_rows_bwd_reference(t(g), t(idx), N)
    assert torch.equal(got, want)
    assert torch.equal(GK.segmented_sum(t(g), *GK.sort_by_row(t(idx), N)), want)
    assert torch.equal(GK.gather_rows_bwd(t(g), t(idx), N), want)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_case_backward_matches_jax_gradient(case):
    g, idx, N = _edge_case(case, np.int32)
    tab = np.zeros((idx.shape[0], N, g.shape[2]), np.float32)
    gwant = jax.grad(lambda x: jnp.sum(jax_gather_rows(x, jnp.asarray(idx), True)
                                       * jnp.asarray(g)))(jnp.asarray(tab))
    got = GK.segmented_sum_reference(t(g), *GK.sort_by_row_reference(t(idx), N))
    # per element within 1e-6 x the sum of |g| over the queries it adds
    bar = 1e-6 * GK.gather_rows_bwd_reference(t(np.abs(g)), t(idx), N).numpy()
    assert (np.abs(got.numpy() - np.asarray(gwant)) <= bar).all()


@pytest.mark.parametrize("n_rows,n_queries,want", [
    (1024, 65536, (16, 16)), (1024, 20480, (16, 16)), (1024, 5000, (5, 16)), (17, 33, (1, 16)),
    (1024, 0, (1, 16)), (12000, 20000, (16, 2)), (19000, 100, (2, 1))])
def test_sort_plan(n_rows, n_queries, want):
    """The sort's blocks per sample and warps per block follow from the
    shape: the counters of all warps fit a block's shared memory."""
    G, W = GK._sort_plan(n_rows, n_queries)
    assert (G, W) == want
    assert (W + 2) * (n_rows + 1) * 4 + 256 <= 227 * 1024


def test_sort_refuses_more_rows_than_its_counters_hold():
    with pytest.raises(ValueError, match="table rows"):
        GK._sort_plan(60_000, 100)
    with pytest.raises(ValueError):
        GK.sort_by_row(torch.zeros((2, 5)), 8)  # float indices
    with pytest.raises(ValueError):
        GK.segmented_sum(torch.zeros((2, 5, 3)), torch.zeros((2, 9), dtype=torch.int64),
                         torch.zeros((2, 5), dtype=torch.int32))
