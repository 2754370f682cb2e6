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
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'a_robust_registration_loss_tpu')]\n"
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
