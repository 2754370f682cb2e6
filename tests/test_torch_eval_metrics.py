"""The port's registration accuracy metrics (eval/metrics.py) against the
JAX package's ``eval/metrics.py`` on the CPU: 1e-6 absolute on O(1) values;
Euler angles are in degrees (O(100)), held to 1e-4 degrees.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.eval import metrics as JEM
from a_robust_registration_loss_tpu.se3 import se3 as JSE3
from a_robust_registration_loss_tpu_torch.eval import metrics as EM
from torch_port_helpers import t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def poses():
    """Two sets of 6 rigid transforms (4, 4) from small-to-moderate twists."""
    rng = np.random.default_rng(0)
    tw = rng.uniform(-0.8, 0.8, (2, 6, 6)).astype(np.float32)
    g = np.asarray(jax.vmap(jax.vmap(JSE3.exp))(jnp.asarray(tw)))
    return g[0], g[1]


@pytest.mark.parametrize("seq", ["xyz", "zyx"])
def test_mat2euler_degrees(poses, seq):
    R = poses[0][:, :3, :3]
    want = np.asarray(JEM.mat2euler(jnp.asarray(R), seq))
    np.testing.assert_allclose(EM.mat2euler(t(R), seq).numpy(), want, atol=1e-4)
    rad = EM.mat2euler(t(R), seq, degrees=False).numpy()
    np.testing.assert_allclose(np.degrees(rad), want, atol=1e-4)
    with pytest.raises(ValueError):
        EM.mat2euler(t(R), "yxz")


def test_monitors_match_jax(poses):
    g1, g2 = poses
    R1, t1, R2, t2 = g1[:, :3, :3], g1[:, :3, 3], g2[:, :3, :3], g2[:, :3, 3]
    rng = np.random.default_rng(1)
    p, q = rng.standard_normal((2, 6, 20, 3)).astype(np.float32)
    j = [jnp.asarray(x) for x in (R1, t1, R2, t2, p, q)]
    k = [t(x) for x in (R1, t1, R2, t2, p, q)]
    pairs = [
        (EM.rotation_mse(k[0], k[2]), JEM.rotation_mse(j[0], j[2])),
        (EM.translation_mse(k[1], k[3]), JEM.translation_mse(j[1], j[3])),
        (EM.pp_wise_rmse(k[4], k[5]), JEM.pp_wise_rmse(j[4], j[5])),
        (EM.pp_wise_mae(k[4], k[5]), JEM.pp_wise_mae(j[4], j[5])),
        (EM.gt_consistency_loss(*k[:4]), JEM.gt_consistency_loss(*j[:4])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    for got, want in zip(EM.rotation_euler_errors(k[0], k[2], "xyz"),
                         JEM.rotation_euler_errors(j[0], j[2], "xyz")):
        np.testing.assert_allclose(float(got), float(want), atol=1e-4)  # degrees


def test_twist_metrics_match_jax(poses):
    g1, g2 = poses
    dm, dn = EM.dm_twist_error(t(g1), t(g2))
    dm_j, dn_j = JEM.dm_twist_error(jnp.asarray(g1), jnp.asarray(g2))
    np.testing.assert_allclose(dn.numpy(), np.asarray(dn_j), atol=1e-6)
    np.testing.assert_allclose(float(dm), float(dm_j), atol=1e-6)
    rows = EM.twist_csv_rows(t(g1), t(g2)).numpy()
    assert rows.shape == (6, 12)
    np.testing.assert_allclose(rows, np.asarray(JEM.twist_csv_rows(jnp.asarray(g1),
                                                                   jnp.asarray(g2))), atol=1e-6)
    assert EM.TWIST_CSV_HEADER == JEM.TWIST_CSV_HEADER
    # the identity composition means zero error
    inv = np.linalg.inv(g1.astype(np.float64)).astype(np.float32)
    assert float(EM.dm_twist_error(t(g1), t(inv))[0]) < 1e-5
