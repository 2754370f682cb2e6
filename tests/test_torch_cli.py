"""The port's command lines on the CPU (``--device cpu``): the dataset
builder, the neighbour precompute and the depth CLI, then DCP's, FMR's and
RPM-Net's trainers: one epoch, the resume, ``--eval_only``,
``--init_from_ckpt`` and ``--init_from_torch``, writing the JAX CLIs' files
(compare tests/test_cli.py); ``--dtype bfloat16``, ``--debug_nans`` and
``--debug`` train, ``--dp`` and ``--sp`` exit naming their ROADMAP.md
item.

The dataset is built by the port's own ``make_dataset.main``. The
trainers' metrics go to ``metrics.jsonl`` only: importing tensorboard
takes longer than these runs, and its events are an optional extra.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from a_robust_registration_loss_tpu_torch.data import depth, make_dataset, objio, precompute
from a_robust_registration_loss_tpu_torch.train import dcp, fmr, rpmnet
from a_robust_registration_loss_tpu_torch.utils import logging as ulog
from torch_port_helpers import sphere_cloud

torch.set_num_threads(1)
COMMON = ["--device", "cpu", "--n_pairs", "3", "--train_count", "2", "--batch_size", "1",
          "--n_lines", "64", "--seed", "7"]
DCP_SMALL = ["--emb_dims", "32", "--n_heads", "2", "--ff_dims", "32"]
FMR_SMALL = ["--dim_k", "32", "--train_maxiter", "2", "--eval_maxiter", "2"]
RPM_SMALL = ["--feat_dim", "16", "--num_neighbors", "8", "--num_sk_iter", "2", "--radius",
             "0.5", "--train_reg_iter", "1", "--eval_reg_iter", "2"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(ulog, "_try_tensorboard", lambda logdir: None)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """3 pairs in the indexed layout from one noisy base cloud, through
    ``make_dataset.main``."""
    root = tmp_path_factory.mktemp("cli")
    (root / "src").mkdir()
    objio.write_obj(str(root / "src" / "base.obj"),
                    sphere_cloud(200, np.random.default_rng(0), noise=0.01))
    n = make_dataset.main(["--sources", str(root / "src" / "*.obj"), "--out",
                           str(root / "data"), "--n_views", "3", "--num_points", "64",
                           "--num_sample", "48", "--rot_mag", "20", "--trans_mag", "0.1",
                           "--indexed", "--device", "cpu"])
    assert n == 3
    return str(root / "data")


def test_dataset_clis(data, tmp_path, monkeypatch):
    path = os.path.join(data, "0_src_sample_neigh.bin")
    before = np.fromfile(path, np.float32)
    for name in sorted(os.listdir(data)):
        assert not name.startswith("0_") or name in {
            "0_src_sample.obj", "0_tar_sample.obj", "0_src_sample_normals.obj",
            "0_tar_sample_normals.obj", "0_src_sample_neigh.bin", "0_tar_sample_neigh.bin",
            "0_transform.bin"}, name
    precompute.main(["--data_path", data, "--num_sample", "48", "--overwrite", "--write_obj",
                     "--device", "cpu"])
    after = np.fromfile(path, np.float32)
    # the OBJ text round trip quantises the cloud the buffer was drawn from
    np.testing.assert_allclose(after, before, atol=1e-4)
    assert os.path.exists(os.path.join(data, "0_src_sample_neigh.obj"))
    os.remove(os.path.join(data, "0_src_sample_neigh.obj"))
    os.remove(os.path.join(data, "0_tar_sample_neigh.obj"))

    from PIL import Image

    d = 1000.0 + np.arange(40)[:, None] * 2.0 + np.arange(48)[None, :]
    Image.fromarray(d.astype(np.uint16)).save(str(tmp_path / "a_depth.png"))
    np.savetxt(str(tmp_path / "a_pose.txt"), np.eye(4))
    depth.main(["--data_path", str(tmp_path), "--num", "32", "--subset", "500",
                "--device", "cpu"])
    v, _ = objio.read_obj(str(tmp_path / "a_depth_sample.obj"))
    n, _ = objio.read_obj(str(tmp_path / "a_depth_sample_normals.obj"))
    assert v.shape == n.shape == (32, 3) and np.isfinite(n).all()
    with open(tmp_path / "poses.json") as f:
        assert json.load(f) == {"a_depth.png": np.eye(4).tolist()}

    # without --device cpu they run on the card, and refuse to fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((precompute.main, ["--data_path", data]),
                       (depth.main, ["--data_path", str(tmp_path)]),
                       (make_dataset.main, ["--sources", "x", "--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def _epochs(exp):
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if r["tag"] == "time/epoch_seconds"]


def _save_reference(model, path):
    """A reference-style ``.pth``: DataParallel's ``module.`` prefix inside a
    ``{"state_dict": ...}`` container, an epoch counter beside it."""
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()},
                "epoch": 7}, path)


def _same_params(a, b):
    return all(torch.equal(v, b[k]) for k, v in a.items()) and a.keys() == b.keys()


def _trains_with_dtype_and_debug_flags(main, args, tmp_path, monkeypatch):
    """``--dtype bfloat16``, ``--debug_nans`` and ``--debug`` train an epoch:
    bf16 with fp32 parameters; under the NaN checks the same losses as
    without them, the checks off again afterwards."""
    from a_robust_registration_loss_tpu_torch.utils import debug

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)  # --debug installs a pdb hook
    base = args + ["--epochs", "1"]
    model, _, hist = main(base + ["--exp_dir", str(tmp_path / "bf16"), "--dtype", "bfloat16"])
    assert model.cfg.dtype == "bfloat16" and np.isfinite(hist[0]["loss"])
    assert hist[0]["nonfinite_steps"] == 0.0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _, _, plain = main(base + ["--exp_dir", str(tmp_path / "plain")])
    for flag in ("--debug_nans", "--debug"):
        _, _, hist = main(base + ["--exp_dir", str(tmp_path / flag[2:]), flag])
        assert hist == plain and not debug.nan_checks_on()
    assert getattr(sys.excepthook, "arrl_pdb_hook", False)


def test_dcp_cli(data, tmp_path, monkeypatch):
    exp, exp2 = str(tmp_path / "exp"), str(tmp_path / "exp2")
    args = ["--data_path", data] + COMMON + DCP_SMALL
    model, _, hist = dcp.main(args + ["--exp_dir", exp, "--epochs", "1"])
    assert [h["epoch"] for h in hist] == [0] and np.isfinite(hist[0]["loss"])
    _, _, hist = dcp.main(args + ["--exp_dir", exp, "--epochs", "2"])
    assert [h["epoch"] for h in hist] == [1] and _epochs(exp) == [0, 1]
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        "checkpoints.json", "ckpt-0", "ckpt-1", "ckpt-best"]
    summary = dcp.main(args + ["--exp_dir", exp, "--eval_only"])
    with open(os.path.join(exp, "eval", "Eval.json")) as f:
        assert json.load(f) == summary
    assert "1_0pred_src.obj" in os.listdir(os.path.join(exp, "eval"))  # epoch 1, pair 0

    from a_robust_registration_loss_tpu_torch.utils import load_params_from

    template = {"params": model.state_dict(), "opt_state": None, "epoch": 0}
    loaded = load_params_from(exp, template)
    start, _, hist = dcp.main(args + ["--exp_dir", exp2, "--init_from_ckpt", exp,
                                      "--epochs", "0"])
    assert hist == [] and _same_params(start.state_dict(), loaded)
    pth = str(tmp_path / "ref.pth")
    _save_reference(start, pth)
    start, _, _ = dcp.main(args + ["--exp_dir", str(tmp_path / "exp3"), "--init_from_torch",
                                   pth, "--epochs", "0"])
    assert _same_params(start.state_dict(), loaded)
    for flag in (["--dp", "2"], ["--sp", "2"]):
        with pytest.raises(SystemExit):
            dcp.main(args + ["--exp_dir", exp2] + flag)
    _trains_with_dtype_and_debug_flags(dcp.main, args, tmp_path, monkeypatch)
    with pytest.raises(SystemExit):
        dcp.main(args + ["--init_from_ckpt", exp, "--init_from_torch", pth])


def test_fmr_cli(data, tmp_path, monkeypatch):
    exp, exp2 = str(tmp_path / "exp"), str(tmp_path / "exp2")
    args = ["--data_path", data] + COMMON + FMR_SMALL
    model, _, hist = fmr.main(args + ["--exp_dir", exp, "--epochs", "1"])
    assert [h["epoch"] for h in hist] == [0] and np.isfinite(hist[0]["loss"])
    assert hist[0]["n_singular"] == 0.0 and "test_dm" in hist[0]
    _, _, hist = fmr.main(args + ["--exp_dir", exp, "--epochs", "2"])
    assert [h["epoch"] for h in hist] == [1] and _epochs(exp) == [0, 1]
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        "checkpoints.json", "ckpt-0", "ckpt-1", "ckpt-best"]
    mean_dm = fmr.main(args + ["--exp_dir", exp, "--eval_only"])
    with open(os.path.join(exp, "eval", "eval_summary.json")) as f:
        assert json.load(f) == {"mean_dm": mean_dm, "n": 1}
    rows = np.loadtxt(os.path.join(exp, "eval", "eval_twists.csv"), delimiter=",",
                      skiprows=1, ndmin=2)
    assert rows.shape == (1, 12) and np.isfinite(mean_dm)
    noisy = fmr.main(args + ["--exp_dir", exp, "--eval_only", "--add_noise", "--add_density"])
    assert np.isfinite(noisy) and noisy != mean_dm

    from a_robust_registration_loss_tpu_torch.utils import load_params_from

    loaded = load_params_from(exp, {"params": model.state_dict(), "opt_state": None,
                                    "epoch": 0})
    start, _, hist = fmr.main(args + ["--exp_dir", exp2, "--init_from_ckpt", exp,
                                      "--epochs", "0"])
    assert hist == [] and _same_params(start.state_dict(), loaded)
    pth = str(tmp_path / "ref.pth")
    _save_reference(start, pth)
    start, _, _ = fmr.main(args + ["--exp_dir", str(tmp_path / "exp3"), "--init_from_torch",
                                   pth, "--epochs", "0"])
    assert _same_params(start.state_dict(), loaded)
    # the reference's evaluation load: decoder.* stripped, the rest taken
    exp4 = str(tmp_path / "exp4")
    torch.save({k: v for k, v in loaded.items() if not k.startswith("encoder.")}, pth)
    with pytest.raises(KeyError, match="missing"):
        fmr.main(args + ["--exp_dir", exp4, "--eval_only", "--init_from_torch", pth])
    _save_reference(start, pth)
    dm = fmr.main(args + ["--exp_dir", exp4, "--eval_only", "--init_from_torch", pth])
    with torch.no_grad():
        for k, v in start.state_dict().items():
            if k.startswith("decoder."):
                v.fill_(float("nan"))  # stripped: never read
    _save_reference(start, pth)
    assert fmr.main(args + ["--exp_dir", exp4, "--eval_only", "--init_from_torch",
                            pth]) == dm and np.isfinite(dm)
    for flag in (["--dp", "2"], ["--sp", "2"]):
        with pytest.raises(SystemExit):
            fmr.main(args + ["--exp_dir", exp2] + flag)
    _trains_with_dtype_and_debug_flags(fmr.main, args, tmp_path, monkeypatch)


def test_rpmnet_cli(data, tmp_path, capsys, monkeypatch):
    exp, exp2 = str(tmp_path / "exp"), str(tmp_path / "exp2")
    args = ["--data_path", data] + COMMON + RPM_SMALL
    model, state, hist = rpmnet.main(args + ["--exp_dir", exp, "--epochs", "1",
                                             "--pretrain_epochs", "1"])
    assert [h["epoch"] for h in hist] == [0] and np.isfinite(hist[0]["loss"])
    # 2 pretraining and 2 training steps: Adam's count runs on, the schedule's restarted
    assert int(state.adam.count) == 4 and int(state.count) == 2
    assert {"loss_reg", "loss_intersection", "test_loss", "test_loss_chamfer"} <= set(hist[0])
    _, state, hist = rpmnet.main(args + ["--exp_dir", exp, "--epochs", "2"])
    assert [h["epoch"] for h in hist] == [1] and _epochs(exp) == [0, 1]
    assert int(state.adam.count) == 6 and int(state.count) == 4
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        "checkpoints.json", "ckpt-0", "ckpt-1", "ckpt-best"]
    summary = rpmnet.main(args + ["--exp_dir", exp, "--eval_only"])
    with open(os.path.join(exp, "eval", "Val.json")) as f:
        assert json.load(f) == summary and set(summary) == {"loss_gt", "loss_chamfer"}
    names = os.listdir(os.path.join(exp, "eval"))
    assert {"1_pred_src_0.bin", "pair0_src.obj", "pair0_pred_src.obj", "pair0_tar.obj",
            "pair0_gt_src.obj"} <= set(names)  # epoch 1, pair 0

    from a_robust_registration_loss_tpu_torch.utils import load_params_from

    loaded = load_params_from(exp, {"params": model.state_dict(), "opt_state": None,
                                    "epoch": 0})
    start, _, hist = rpmnet.main(args + ["--exp_dir", exp2, "--init_from_ckpt", exp,
                                         "--epochs", "0"])
    assert hist == [] and _same_params(start.state_dict(), loaded)
    # a reference-layout .pth: the annealing net's last layer with 2 + 3 outputs
    pth = str(tmp_path / "ref.pth")
    ref = {k: v.clone() for k, v in loaded.items()}
    for k in ("weights_net.postpool.6.weight", "weights_net.postpool.6.bias"):
        ref[k] = torch.cat([ref[k], torch.randn((3,) + ref[k].shape[1:])])
    torch.save({"state_dict": {f"module.{k}": v for k, v in ref.items()}, "epoch": 7}, pth)
    start, _, _ = rpmnet.main(args + ["--exp_dir", str(tmp_path / "exp3"), "--init_from_torch",
                                      pth, "--epochs", "0"])
    assert _same_params(start.state_dict(), loaded)
    from_torch = rpmnet.main(args + ["--exp_dir", str(tmp_path / "exp4"), "--eval_only",
                                     "--init_from_torch", pth])
    assert from_torch == summary

    # the ablations and the data flags
    _, _, hist = rpmnet.main(args + ["--exp_dir", str(tmp_path / "exp5"), "--epochs", "1",
                                     "--anneal", "constant", "--no_slack", "--features",
                                     "ppf,xyz", "--estimate_normals", "--noise_type", "jitter",
                                     "--rot_mag", "10", "--num_points", "48"])
    assert np.isfinite(hist[0]["loss"])
    capsys.readouterr()
    for flag in (["--dp", "2"], ["--sp", "2"]):
        with pytest.raises(SystemExit):
            rpmnet.main(args + ["--exp_dir", exp2] + flag)
        assert "ROADMAP.md Queue 1 item 7" in capsys.readouterr().err
    _trains_with_dtype_and_debug_flags(rpmnet.main, args, tmp_path, monkeypatch)
    for bad in (["--init_from_ckpt", exp, "--init_from_torch", pth], ["--partial", "0.5"]):
        with pytest.raises(SystemExit):
            rpmnet.main(args + ["--exp_dir", exp2] + bad)
