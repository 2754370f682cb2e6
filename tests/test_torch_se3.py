"""The port's se3/ (sinc, so3, se3) against the JAX package.

Tolerances: values atol 1e-6, autograd gradients atol 1e-5 (fp32, same
formulas; the exact branches' gradients cancel catastrophically near the
0.01 switch, where the two frameworks' sin/cos may differ by an ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.se3 import se3 as JSE3
from a_robust_registration_loss_tpu.se3 import sinc as JS
from a_robust_registration_loss_tpu.se3 import so3 as JSO3
from a_robust_registration_loss_tpu_torch.se3 import se3 as SE3
from a_robust_registration_loss_tpu_torch.se3 import sinc as TS
from a_robust_registration_loss_tpu_torch.se3 import so3 as SO3
from torch_port_helpers import t

torch.set_num_threads(1)

# both sides of the |t| < 0.01 Taylor switch, and 0 itself
T_SWITCH = np.array([0.0, 0.004, -0.0099, 0.0101, -0.0101, 0.015, 0.05, 0.3,
                     2.5, -1.2], np.float32)
# where the derivative functions' own gradients are well conditioned in fp32
T_SMOOTH = np.array([0.0, 0.004, -0.0099, 1.2, 2.5, -1.7], np.float32)


def _value_and_grad(jf, tf, ts):
    vj = np.asarray(jax.vmap(jf)(jnp.asarray(ts)))
    gj = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(ts)))
    x = torch.tensor(ts, requires_grad=True)
    v = tf(x)
    (g,) = torch.autograd.grad(v.sum(), x)
    return vj, gj, v.detach().numpy(), g.numpy()


@pytest.mark.parametrize("name", ["sinc1", "sinc2", "sinc3"])
def test_sinc_values_and_grads(name):
    vj, gj, vt, gt = _value_and_grad(getattr(JS, name), getattr(TS, name),
                                     T_SWITCH)
    np.testing.assert_allclose(vt, vj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gt, gj, atol=1e-5, rtol=0)
    assert np.isfinite(gt).all()


@pytest.mark.parametrize("name", ["sinc1_dt", "rsinc1", "sinc2_dt",
                                  "sinc3_dt"])
def test_sinc_family_values(name):
    vj, gj, vt, gt = _value_and_grad(getattr(JS, name), getattr(TS, name),
                                     T_SWITCH)
    np.testing.assert_allclose(vt, vj, atol=1e-6, rtol=0)
    vj, gj, vt, gt = _value_and_grad(getattr(JS, name), getattr(TS, name),
                                     T_SMOOTH)
    np.testing.assert_allclose(gt, gj, atol=1e-5, rtol=0)


TWISTS = np.array([
    [0.0, 0.0, 0.0, 0.1, -0.2, 0.3],
    [0.003, -0.002, 0.001, 0.01, 0.0, -0.02],
    [0.4, -0.3, 0.6, 0.2, 0.0, -0.1],
    [1.1, 2.0, -0.7, -0.5, 0.3, 0.8],
], np.float32)


@pytest.mark.parametrize("i", range(len(TWISTS)))
def test_exp3_values_and_grads(i):
    x = TWISTS[i]

    def jf(v):
        R, p = JSE3.exp3(v)
        return jnp.sum(R * jnp.arange(9.0).reshape(3, 3)) + jnp.sum(p * jnp.array([1.0, -2.0, 3.0]))

    Rj, pj = JSE3.exp3(jnp.asarray(x))
    gj = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    Rt, pt = SE3.exp3(xt)
    obj = ((Rt * torch.arange(9.0).reshape(3, 3)).sum()
           + (pt * torch.tensor([1.0, -2.0, 3.0])).sum())
    (gt,) = torch.autograd.grad(obj, xt)
    np.testing.assert_allclose(Rt.detach().numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), gj, atol=1e-5)
    assert np.isfinite(gt.numpy()).all()


def test_exp_inverse_transform():
    x = TWISTS[2:]
    g = SE3.exp(t(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(JSE3.exp(jnp.asarray(x))),
                               atol=1e-6)
    gi = SE3.inverse(g)
    np.testing.assert_allclose((g @ gi).numpy(), np.broadcast_to(np.eye(4), g.shape),
                               atol=1e-6)
    pts = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        SE3.transform(g[:, None], t(pts)).numpy(),
        np.asarray(JSE3.transform(JSE3.exp(jnp.asarray(x))[:, None], jnp.asarray(pts))),
        atol=1e-6)


@pytest.mark.parametrize("w", [
    [0.2, -0.1, 0.3],
    [0.0, 0.0, 0.0],
    [np.pi, 0.0, 0.0],                     # the pi branch
    [0.0, np.pi * 0.6, np.pi * 0.8],       # |w| = pi, off-axis
])
def test_so3_log(w):
    w = np.asarray(w, np.float32)
    R = np.asarray(JSO3.exp(jnp.asarray(w)))
    lj = np.asarray(JSO3.log(jnp.asarray(R)))
    lt = SO3.log(t(R)).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-6)
    # and the log round-trips through exp
    np.testing.assert_allclose(SO3.exp(t(lt)).numpy(), R, atol=1e-5)


def test_se3_log_matches_and_inverts_exp():
    x = TWISTS[2]
    g = np.asarray(JSE3.exp(jnp.asarray(x)))
    np.testing.assert_allclose(SE3.log(t(g)).numpy(),
                               np.asarray(JSE3.log(jnp.asarray(g))), atol=1e-6)
    np.testing.assert_allclose(SE3.log(t(g)).numpy(), x, atol=1e-5)


def test_rt_helpers_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 6)).astype(np.float32) * 0.5
    g = np.asarray(JSE3.exp(jnp.asarray(x)))[:, :3, :]
    pts = rng.standard_normal((3, 7, 3)).astype(np.float32)
    pairs = [
        (SE3.rt_inverse(t(g)), JSE3.rt_inverse(jnp.asarray(g))),
        (SE3.rt_concatenate(t(g), t(g[::-1].copy())),
         JSE3.rt_concatenate(jnp.asarray(g), jnp.asarray(g[::-1]))),
        (SE3.rt_transform(t(g), t(pts)),
         JSE3.rt_transform(jnp.asarray(g), jnp.asarray(pts))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_array_equal(SE3.rt_identity((2,)).numpy(),
                                  np.asarray(JSE3.rt_identity((2,))))
