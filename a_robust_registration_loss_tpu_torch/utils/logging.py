"""Observability: scalar metrics writer, tee'd run logs, python logging.

Port of ``a_robust_registration_loss_tpu/utils/logging.py``. Scalars always
land in an append-only JSONL file (``{"tag", "value", "step", "time"}`` a
line, the JAX writer's records); a TensorBoard event stream is written as
well where ``torch.utils.tensorboard`` imports. Writes happen on the host,
with values the caller has already fetched.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def _try_tensorboard(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # no tensorboard package: the JSONL file only
        return None
    return SummaryWriter(logdir)


class MetricsWriter:
    """add_scalar(tag, value, step) -> metrics.jsonl (+ TB events when
    available)."""

    def __init__(self, logdir: str, tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = _try_tensorboard(logdir) if tensorboard else None

    def add_scalar(self, tag: str, value, step: int):
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_scalars(self, scalars: dict, step: int, prefix: str = ""):
        for k, v in scalars.items():
            self.add_scalar(prefix + k, v, step)

    def flush(self):
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class IOStream:
    """Tee console prints to a run log file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.f = open(path, "a")

    def cprint(self, text: str):
        print(text)
        self.f.write(text + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


class Colors:
    """ANSI console colours."""

    BLUE = "\033[34m"
    CYAN = "\033[36m"
    GREEN = "\033[32m"
    RED = "\033[31m"
    END = "\033[0m"

    @staticmethod
    def wrap(text: str, color: str) -> str:
        return f"{color}{text}{Colors.END}"


def dict_to_file(path: str, d: dict, file_type: str = "json"):
    """Persist a metrics dict as json or key:value text."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if file_type == "json":
        with open(path, "w") as f:
            json.dump({k: float(v) if hasattr(v, "__float__") else v
                       for k, v in d.items()}, f, indent=1)
    else:
        with open(path, "w") as f:
            for k, v in d.items():
                f.write(f"{k}: {v}\n")


def prepare_logger(log_path: str, name: Optional[str] = None) -> logging.Logger:
    """File + console logger that records argv on startup."""
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    logger = logging.getLogger(name or log_path)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(
        "%(asctime)s [%(levelname)s] %(message)s"))
    sh = logging.StreamHandler(sys.stdout)
    sh.setLevel(logging.INFO)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    logger.info("command: %s", " ".join(sys.argv))
    return logger
