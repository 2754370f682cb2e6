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
