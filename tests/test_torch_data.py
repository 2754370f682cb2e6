"""The port's data readers and its register CLI on the CPU.

The OBJ and PLY readers must return exactly the JAX package's arrays for
the same files; ``register`` runs end to end with ``--device cpu``.
"""

import numpy as np
import pytest
import torch

from a_robust_registration_loss_tpu.data import objio as JO
from a_robust_registration_loss_tpu.data import plyio as JP
from a_robust_registration_loss_tpu_torch import register
from a_robust_registration_loss_tpu_torch.data import objio, plyio
from torch_port_helpers import sphere_cloud

torch.set_num_threads(1)


@pytest.fixture
def cloud():
    return sphere_cloud(200, np.random.default_rng(3), noise=0.02)


def test_obj_roundtrip_matches_jax_reader(tmp_path, cloud):
    faces = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    path = str(tmp_path / "a" / "cloud.obj")
    objio.write_obj(path, cloud, faces)
    v, f = objio.read_obj(path)
    vj, fj = JO.read_obj(path)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_allclose(v, cloud, rtol=1e-7)


@pytest.mark.parametrize("binary", [False, True])
def test_ply_reader_matches_jax(tmp_path, cloud, binary):
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    path = str(tmp_path / "cloud.ply")
    JP.write_ply(path, cloud, faces, binary=binary, colors=(0.2, 0.4, 0.6))
    v, f = plyio.read_ply(path)
    vj, fj = JP.read_ply(path)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)


def test_register_cli_on_cpu(tmp_path, cloud):
    src = str(tmp_path / "src.obj")
    tar = str(tmp_path / "tar.ply")
    objio.write_obj(src, cloud)
    JP.write_ply(tar, cloud + np.float32(0.05))
    out = str(tmp_path / "o" / "T.txt")
    pred = str(tmp_path / "pred.obj")
    register.main([src, tar, "--out", out, "--pred_out", pred, "--n_epochs", "3",
                   "--n_lines", "64", "--num_sample", "64", "--uncentered",
                   "--device", "cpu"])
    T = np.loadtxt(out)
    assert T.shape == (3, 4) and np.isfinite(T).all()
    assert objio.read_obj(pred)[0].shape == cloud.shape
