"""The port's demo and its file writers (demo.py, utils/viz.py,
data/plyio.py:write_ply) against the JAX package's.

``write_ply`` and the ply triple of ``draw_registration_result`` write the
same bytes as the JAX package's for every combination of format, faces and
colours; the demo, single and batched, writes the same file names as the
JAX demo run with the same arguments (``--backend xla``), and every chamfer
it logs is finite.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from a_robust_registration_loss_tpu import demo as JDEMO
from a_robust_registration_loss_tpu.data import plyio as JPLY
from a_robust_registration_loss_tpu.utils import viz as JVIZ
from a_robust_registration_loss_tpu_torch import demo as DEMO
from a_robust_registration_loss_tpu_torch.data import objio, plyio
from a_robust_registration_loss_tpu_torch.utils import viz
from torch_port_helpers import sphere_cloud

torch.set_num_threads(1)

COLORS = {"none": None, "uniform_float": (1.0, 0.706, 0.0),
          "uniform_int": np.array([255, 30, 7], np.int64),
          "per_vertex_float": None, "per_vertex_uint8": None}  # drawn in the test


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
@pytest.mark.parametrize("faces", [False, True], ids=["points", "faces"])
@pytest.mark.parametrize("colors", list(COLORS))
def test_write_ply_same_bytes(tmp_path, binary, faces, colors):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((17, 3)).astype(np.float32)
    f = rng.integers(0, 17, (5, 3)) if faces else None
    c = COLORS[colors]
    if colors == "per_vertex_float":
        c = rng.uniform(-0.2, 1.2, (17, 3))
    elif colors == "per_vertex_uint8":
        c = rng.integers(0, 256, (17, 3)).astype(np.uint8)
    plyio.write_ply(str(tmp_path / "port.ply"), v, f, binary=binary, colors=c)
    JPLY.write_ply(str(tmp_path / "jax.ply"), v, f, binary=binary, colors=c)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    got, got_f = plyio.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(got, v)
    assert got_f.shape == ((5, 3) if faces else (0, 3))


def test_registration_result_same_ply_triple_and_png(tmp_path):
    rng = np.random.default_rng(4)
    src, tar = sphere_cloud(64, rng, 0.01), sphere_cloud(70, rng, 0.01)
    g = np.eye(4)
    g[:3, :3] = [[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]]
    g[:3, 3] = [0.1, -0.2, 0.05]
    out = viz.draw_registration_result(src, tar, g, str(tmp_path / "port"))
    want = JVIZ.draw_registration_result(src, tar, g, str(tmp_path / "jax"), png=False)
    for name in ("source_pre", "source", "target"):
        with open(out[name], "rb") as a, open(want[name], "rb") as b:
            assert a.read() == b.read(), name
    assert os.path.getsize(out["png"]) > 0
    assert sorted(os.listdir(tmp_path / "port")) == [
        "registration.png", "source.ply", "source_pre.ply", "target.ply"]


@pytest.fixture(scope="module")
def obj_pairs(tmp_path_factory):
    """Two tiny OBJ pairs: an ellipsoid and its rotated, shifted copy."""
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    for k in range(2):
        a = 0.2 + 0.05 * k
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                     np.float32)
        src = sphere_cloud(150, rng, 0.01) * np.float32([1.0, 0.7, 0.5])
        objio.write_obj(str(d / f"{k}_src_sample.obj"), src)
        objio.write_obj(str(d / f"{k}_tar_sample.obj"), src @ R + np.float32(0.03))
    return str(d)


def _argv(data, out, labels=None):
    argv = ["--data_path", data, "--Save_path", out, "--n_epochs", "20", "--n_lines", "128",
            "--num_sample", "64"]
    return argv + (["--labels", labels] if labels else [])


def _jax_args(data, out, labels=None):
    """The JAX demo's parsed arguments for the same run, on its XLA path
    (its ``main`` / ``main_batch`` called directly: its ``cli`` would also
    point the JAX compile cache at a directory under the home)."""
    return argparse.Namespace(data_path=data, label1="0", Save_path=out, seed=123,
                              n_epochs=20, n_lines=128, num_sample=64, log_every=10,
                              line_chunk=4096, backend="xla", labels=labels)


def test_demo_single_writes_the_jax_demos_files(obj_pairs, tmp_path, capsys):
    hist = DEMO.cli(_argv(obj_pairs, str(tmp_path / "port")) + ["--device", "cpu"])
    JDEMO.main(_jax_args(obj_pairs, str(tmp_path / "jax")))
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert {"10.obj", "20_transform.txt", "target.obj", "source.ply",
            "registration.png"} <= set(files)
    assert hist["chamfer"].shape == (20,) and np.isfinite(hist["chamfer"]).all()
    out = capsys.readouterr().out
    assert "epoch    20  chamfer" in out and "final chamfer" in out
    assert np.loadtxt(tmp_path / "port" / "20_transform.txt").shape == (3, 4)


def test_demo_batched_writes_the_jax_demos_files(obj_pairs, tmp_path, capsys):
    hist = DEMO.cli(_argv(obj_pairs, str(tmp_path / "port"), "0,1") + ["--device", "cpu"])
    JDEMO.main_batch(_jax_args(obj_pairs, str(tmp_path / "jax"), "0,1"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "0_transform.txt", "1_transform.txt"]
    assert hist["chamfer"].shape == (20, 2) and np.isfinite(hist["chamfer"]).all()
    assert "pair-iters/sec" in capsys.readouterr().out


def test_demo_without_matplotlib_skips_only_the_png(obj_pairs, tmp_path, capsys,
                                                   monkeypatch):
    """Where matplotlib is not installed the demo says the PNG was skipped
    and writes everything else."""
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    DEMO.cli(_argv(obj_pairs, str(tmp_path)) + ["--device", "cpu"])
    files = set(os.listdir(tmp_path))
    assert "registration.png" not in files
    assert {"source_pre.ply", "source.ply", "target.ply", "target.obj"} <= files
    assert "registration.png skipped: matplotlib does not import" in capsys.readouterr().out


def test_demo_refuses_a_missing_card(obj_pairs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEMO.cli(_argv(obj_pairs, str(tmp_path)))
