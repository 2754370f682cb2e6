"""The PyTorch port stands alone: no file of it (nor chip_smoke.py) imports
jax, optax or the JAX package, importing it loads no JAX, and its entry
points refuse to fall back to the CPU when no GPU is there."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.ops.cuda import probe as PB
from a_robust_registration_loss_tpu_torch.train import classical as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "a_robust_registration_loss_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "a_robust_registration_loss_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_imports_in_port_files():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(p, REPO), m) for p in files for m in _imported_modules(p)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import a_robust_registration_loss_tpu_torch.register\n"
            "import a_robust_registration_loss_tpu_torch.train.classical\n"
            "import a_robust_registration_loss_tpu_torch.data.plyio\n"
            "import a_robust_registration_loss_tpu_torch.ops.metric\n"
            "import a_robust_registration_loss_tpu_torch.ops.cuda.probe\n"
            "import a_robust_registration_loss_tpu_torch.train.losses\n"
            "import a_robust_registration_loss_tpu_torch.train.dcp\n"
            "import a_robust_registration_loss_tpu_torch.models.dcp\n"
            "import a_robust_registration_loss_tpu_torch.models.common\n"
            "import a_robust_registration_loss_tpu_torch.models.transplant\n"
            "import a_robust_registration_loss_tpu_torch.eval.metrics\n"
            "import a_robust_registration_loss_tpu_torch.ops.cuda.gather\n"
            "import a_robust_registration_loss_tpu_torch.demo\n"
            "import a_robust_registration_loss_tpu_torch.utils\n"
            "import a_robust_registration_loss_tpu_torch.utils.viz\n"
            "import a_robust_registration_loss_tpu_torch.train.harness\n"
            "import a_robust_registration_loss_tpu_torch.train.fmr\n"
            "import a_robust_registration_loss_tpu_torch.models.fmr\n"
            "import a_robust_registration_loss_tpu_torch.data.dataset\n"
            "import a_robust_registration_loss_tpu_torch.data.transforms\n"
            "import a_robust_registration_loss_tpu_torch.data.make_dataset\n"
            "import a_robust_registration_loss_tpu_torch.data.precompute\n"
            "import a_robust_registration_loss_tpu_torch.data.depth\n"
            "import a_robust_registration_loss_tpu_torch.native.objio_native\n"
            "import a_robust_registration_loss_tpu_torch.models.rpmnet\n"
            "import a_robust_registration_loss_tpu_torch.train.rpmnet\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'flax', 'a_robust_registration_loss_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((16, 3), np.float32)
    cfg = TC.ClassicalConfig(n_epochs=1, n_lines=8, num_sample=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.run(pts, pts, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.prepare_pair(pts, pts, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.from_jax_state(np.zeros(6), (0, np.zeros(6), np.zeros(6)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.run_batch(pts[None], pts[None], cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.prepare_pairs(pts[None], pts[None], cfg)


def test_trainers_refuse_a_missing_card(monkeypatch, tmp_path):
    """DCP's training and the trainer runtime run on the card unless asked
    for the CPU."""
    from a_robust_registration_loss_tpu_torch.models import dcp as D
    from a_robust_registration_loss_tpu_torch.train import dcp as TD
    from a_robust_registration_loss_tpu_torch.train import harness as H

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fit = H.FitConfig(epochs=1, exp_dir=str(tmp_path), log_tensorboard=False)
    cfg = TD.DCPTrainConfig(model=D.DCPConfig(emb_nn="pointnet", emb_dims=32, ff_dims=64),
                            fit=fit)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.train(cfg, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.init_model(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.Trainer(lambda *a: None, None, fit)
    assert H.Trainer(lambda *a: None, None, fit, device="cpu").device.type == "cpu"


def test_native_code_is_the_ports_own():
    """The port builds its own copy of the OBJ reader, into build/, and
    reads nothing of the JAX package's native directory."""
    from a_robust_registration_loss_tpu_torch.native import objio_native

    assert os.path.dirname(objio_native.SOURCE) == os.path.join(PORT, "native")
    assert objio_native.BUILD_DIR == os.path.join(REPO, "build", "torch_native")
    with open(os.path.join(PORT, "native", "objio_native.py")) as f:
        assert "a_robust_registration_loss_tpu/" not in f.read()


def test_data_layer_and_fmr_refuse_a_missing_card(monkeypatch, tmp_path):
    """FMR's training and CLI, the dataset builders and the device cache run
    on the card unless given the CPU."""
    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.data import make_dataset as MK
    from a_robust_registration_loss_tpu_torch.data import precompute as PC
    from a_robust_registration_loss_tpu_torch.models.fmr import FMRConfig
    from a_robust_registration_loss_tpu_torch.train import fmr as TF
    from a_robust_registration_loss_tpu_torch.train import harness as H

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fit = H.FitConfig(epochs=1, exp_dir=str(tmp_path), log_tensorboard=False)
    cfg = TF.FMRTrainConfig(model=FMRConfig(dim_k=64, num_points=8), fit=fit)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.train(cfg, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.init_model(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.evaluate(cfg, {}, [], str(tmp_path))
    for main, argv in ((TF.main, ["--data_path", str(tmp_path)]),
                       (MK.main, ["--sources", "x", "--out", str(tmp_path)]),
                       (PC.main, ["--data_path", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    pts = np.zeros((4, 3), np.float32)
    objio_path = str(tmp_path / "0_src_sample.obj")
    from a_robust_registration_loss_tpu_torch.data import objio

    for tag in ("src", "tar"):
        objio.write_obj(str(tmp_path / f"0_{tag}_sample.obj"), pts)
        pts.tofile(str(tmp_path / f"0_{tag}_sample_neigh.bin"))
    loader = DS.Loader(DS.RegistrationPairs([objio_path], [objio_path.replace("src", "tar")]),
                       1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DS.DeviceCache(loader)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DS.maybe_device_cache(loader)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DS.PrefetchLoader(loader)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DS.load_pair(objio_path, objio_path.replace("src", "tar"), estimate_normals=True)
    assert isinstance(DS.DeviceCache(loader, device="cpu"), DS.DeviceCache)


def test_probe_and_metric_refuse_a_missing_card(monkeypatch):
    """The rate probe measures the card or fails; stage 1 on a device that
    is neither the CPU nor a card raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.measured_fp32_rate()
    with pytest.raises(ValueError):
        PB.measured_fp32_rate(device="cpu")
    x = torch.zeros((4, 9), device="meta")
    with pytest.raises(ValueError):
        M.find_intersections(x, torch.zeros((3, 6), device="meta"))


def test_evaluate_and_gather_refuse_a_missing_card(monkeypatch, tmp_path):
    """DCP's evaluation runs on the card unless asked for the CPU, and the
    row gather takes CPU tensors (plain version) or CUDA tensors (kernel):
    nothing else, and no fallback."""
    from a_robust_registration_loss_tpu_torch.models import dcp as D
    from a_robust_registration_loss_tpu_torch.ops.cuda import gather as GK
    from a_robust_registration_loss_tpu_torch.train import dcp as TD
    from a_robust_registration_loss_tpu_torch.train import losses as LS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TD.DCPTrainConfig(loss=LS.LossConfig(n_lines=8),
                            model=D.DCPConfig(emb_nn="pointnet", emb_dims=32, ff_dims=64))
    sd = D.DCP(cfg.model).state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.evaluate(cfg, sd, [], str(tmp_path))
    with pytest.raises(ValueError, match="no batch"):  # asked for the CPU: it runs
        TD.evaluate(cfg, sd, [], str(tmp_path), device="cpu")
    table = torch.zeros((1, 4, 3))
    idx = torch.zeros((1, 2), dtype=torch.int64)
    assert GK.gather_rows(table, idx).shape == (1, 2, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        GK.gather_rows(table.to("meta"), idx.to("meta"))


def test_rpmnet_refuses_a_missing_card(monkeypatch, tmp_path):
    """RPM-Net's training, evaluation and CLI run on the card unless asked
    for the CPU; its model takes CPU tensors (the gather's plain version)."""
    from a_robust_registration_loss_tpu_torch.models import rpmnet as R
    from a_robust_registration_loss_tpu_torch.train import harness as H
    from a_robust_registration_loss_tpu_torch.train import rpmnet as TR

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fit = H.FitConfig(epochs=1, exp_dir=str(tmp_path), log_tensorboard=False)
    cfg = TR.RPMTrainConfig(model=R.RPMNetConfig(feat_dim=16, num_neighbors=4), fit=fit)
    for call in (lambda: TR.train(cfg, []), lambda: TR.init_model(cfg, 0),
                 lambda: TR.evaluate(cfg, {}, [], str(tmp_path)),
                 lambda: TR.main(["--data_path", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    m = TR.init_model(cfg, 0, device="cpu")
    x = torch.randn(1, 16, 3)
    transforms, _ = m(x, x, x, x, num_iter=1)
    assert transforms[0].shape == (1, 3, 4) and transforms[0].device.type == "cpu"
