"""The port's row gather (ops/cuda/gather.py) against the JAX package's
``ops/pallas/gather.py`` kernels in interpret mode, on the CPU.

Bars: the forward equals the JAX kernel bit for bit, out-of-range indices
included (zero rows on both sides); the backward through autograd agrees
within rtol 1e-5 / atol 1e-5, the JAX package's own bar for its kernel
against ``take_along_axis`` (the two sum in different orders); the plain
forward equals ``torch.take_along_dim`` bit for bit for in-range idx, and
the plain backward equals a sequential loop in ascending q bit for bit,
which is the order the CUDA kernel promises.
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
