"""The port's shared model components (models/common.py) against the JAX
package's, on the CPU: 1e-6 absolute on O(1) inputs. ``svd_orientation``
and ``weighted_kabsch`` are compared on the rotation they return, never on
singular vectors (their signs are the SVD routine's choice).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from a_robust_registration_loss_tpu.models import common as JC
from a_robust_registration_loss_tpu_torch.models import common as C
from torch_port_helpers import t

torch.set_num_threads(1)
ATOL = 1e-6


def test_quat2mat_xyzw_order():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    got = C.quat2mat(t(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(JC.quat2mat(jnp.asarray(q))), atol=ATOL)
    # (x, y, z, w): the identity quaternion is (0, 0, 0, 1)
    np.testing.assert_allclose(C.quat2mat(torch.tensor([0.0, 0.0, 0.0, 1.0])).numpy(),
                               np.eye(3), atol=0)


@pytest.mark.parametrize("reflect", [False, True], ids=["det>0", "det<0"])
def test_svd_orientation_matches_jax_on_R(reflect):
    """H with well separated singular values; the reflected case has
    det(V U^T) < 0, so V's last column is flipped."""
    rng = np.random.default_rng(1)
    H = rng.standard_normal((6, 3, 3)).astype(np.float32)
    H = H + 2 * np.eye(3, dtype=np.float32)
    if reflect:
        H[:, :, 0] *= -1
    want = np.asarray(JC.svd_orientation(jnp.asarray(H)))
    got = C.svd_orientation(t(H)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    if reflect:
        U, _, Vt = np.linalg.svd(H.astype(np.float64))
        assert (np.linalg.det(np.swapaxes(Vt, -1, -2) @ np.swapaxes(U, -1, -2)) < 0).any()


def test_weighted_kabsch_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 30, 3)).astype(np.float32)
    b = rng.standard_normal((3, 30, 3)).astype(np.float32) * 0.1 + a[:, :, [1, 2, 0]]
    w = rng.uniform(0.1, 1.0, (3, 30)).astype(np.float32)
    want = np.asarray(JC.weighted_kabsch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)))
    got = C.weighted_kabsch(t(a), t(b), t(w)).numpy()
    assert got.shape == (3, 3, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_layernorm_unbiased_std_eps_on_std():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    a = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = JC.TorchLayerNorm().apply({"params": {"a": jnp.asarray(a), "b": jnp.asarray(b)}},
                                     jnp.asarray(x))
    m = C.TorchLayerNorm(16)
    m.load_state_dict({"a_2": t(a), "b_2": t(b)})
    np.testing.assert_allclose(m(t(x)).detach().numpy(), np.asarray(want), atol=ATOL)
    # not nn.LayerNorm: unbiased std, eps outside the square root
    xt = t(x)
    ref = t(a) * (xt - xt.mean(-1, keepdim=True)) / (xt.std(-1, keepdim=True) + 1e-6) + t(b)
    np.testing.assert_allclose(m(xt).detach().numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 9, 16), (3, 16), (2, 5, 4, 16)],
                         ids=["BNC", "BC", "BNkC"])
def test_groupnorm_matches_jax(shape):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    params = {"GroupNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    want = JC.TorchGroupNorm(4).apply({"params": params}, jnp.asarray(x))
    m = C.TorchGroupNorm(4, 16)
    m.load_state_dict({"weight": t(scale), "bias": t(bias)})
    got = m(t(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    if len(shape) == 3:  # torch's own GroupNorm on the channels-first view
        ref = torch.nn.functional.group_norm(t(x).transpose(1, 2), 4, t(scale), t(bias), 1e-5)
        np.testing.assert_allclose(got, ref.transpose(1, 2).numpy(), atol=ATOL)
    with pytest.raises(ValueError):
        C.TorchGroupNorm(3, 16)
