"""The port's fp32 rate probe (ops/cuda/probe.py) against the JAX package's
``bench.py:measured_vpu_peak``, on the CPU.

The JAX probe is a Pallas kernel timed inside ``measured_vpu_peak``. The
test runs that function at a tiny shape with ``pallas_call`` switched to
interpret mode, keeps the kernel body it built, and runs the body again on
its own input. XLA reassociates the kernel's first step: its HLO computes
r * (x * 0.1) with r = x[0] * 3.9 as x * (x[0] * 0.39), folding the two
constants, so the two sides can differ by an ulp from the first step on.
Bars: with r = 2.34 (x[0] = 0.6), where the map contracts and an ulp stays
an ulp, the port's plain version is within 3e-7 relative of that kernel's
output (1 ulp seen); the plain version equals the map as written, in numpy
float32 with one rounding per operation, bit for bit; the operation count
equals ``measured_vpu_peak``'s.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import bench
from a_robust_registration_loss_tpu_torch.ops.cuda import probe as PB

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_probe():
    """measured_vpu_peak at its 4 chains, 1 x 16 steps, one (8, 128) block;
    returns its kernel body and pallas_call arguments."""
    real = pl.pallas_call
    seen = []

    def interpreted(kern, **kw):
        seen.append((kern, kw))
        return real(kern, interpret=True, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interpreted)
        rate, ms = bench.measured_vpu_peak(iters=1, unroll=16, rows=8, cols=128,
                                           grid=1)
    assert rate > 0 and ms > 0
    return seen[0], real


def test_plain_matches_jax_kernel(jax_probe):
    (kern, kw), real = jax_probe
    x = np.random.default_rng(0).uniform(0.05, 0.95, (8, 128)).astype(np.float32)
    x[0, 0] = 0.6
    want = np.asarray(real(kern, interpret=True, **kw)(jnp.asarray(x)))
    got = PB.logistic_map(torch.tensor(x.reshape(-1)), iters=1)
    np.testing.assert_allclose(got.numpy().reshape(8, 128), want, rtol=3e-7, atol=0)


@pytest.mark.parametrize("iters", [0, 1, 2, 5])
def test_plain_matches_float32_recipe(iters):
    """The plain version is the map in float32, one rounding per op, at
    0 (the chains' sum alone) to 5 x 16 steps."""
    # x * (0.1 + 0.2 c) stays in (0, 1), so the map stays bounded
    x = np.random.default_rng(iters).uniform(0.05, 0.65, 1000).astype(np.float32)
    r = x[0] * np.float32(3.9)
    xs = [x * np.float32(0.1 + 0.2 * c) for c in range(PB.CHAINS)]
    for _ in range(iters * PB.UNROLL):
        xs = [(r * v) * (np.float32(1) - v) for v in xs]
    want = xs[0]
    for v in xs[1:]:
        want = want + v
    np.testing.assert_array_equal(PB.logistic_map(torch.tensor(x), iters).numpy(), want)


def test_operation_count_is_bench_py():
    d = {k: v.default for k, v in inspect.signature(bench.measured_vpu_peak).parameters.items()}
    n = d["rows"] * d["cols"] * d["grid"]
    assert (d["unroll"], d["chains"]) == (PB.UNROLL, PB.CHAINS)
    assert PB.operations(n, d["iters"]) == \
        3 * d["iters"] * d["unroll"] * d["chains"] * d["rows"] * d["cols"] * d["grid"]
    assert (PB.N, PB.ITERS) == (n, d["iters"])


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        PB.logistic_map(torch.ones(8, device="meta"), 1)
