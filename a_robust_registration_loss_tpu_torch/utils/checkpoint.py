"""Checkpoint management with the reference CheckPointManager's policy set.

Port of ``a_robust_registration_loss_tpu/utils/checkpoint.py`` on
``torch.save`` / ``torch.load(weights_only=True)`` in place of orbax. The
policies are the JAX manager's:

- each checkpoint is a directory ``ckpt-{step}`` (here holding one
  ``state.pt``: the whole state, plain dicts, lists, tuples, numbers and
  host tensors);
- rolling retention of the latest ``max_to_keep``, where a checkpoint that
  rotates out is promoted to *permanent* (never pruned) once per
  ``keep_every_n_hours`` of save time, and deleted otherwise;
- a separate ``ckpt-best`` copy updated when the score improves
  (``best_mode`` max or min);
- a ``checkpoints.json`` manifest (``rotating``, ``permanent``,
  ``best_step``, ``best_score``, ``next_save_time``) written through a
  temporary file and ``os.replace``;
- ``load`` restoring into the structure of a template (latest, best, or a
  given step); the latest-load skips an unreadable newest checkpoint and
  re-raises when every one fails.

A save copies the state off the device once (every tensor's bytes in one
buffer, one device-to-host copy) before it returns; with ``use_async`` the
file writes then run on a thread, and ``wait_until_finished`` joins it. A
checkpoint directory appears only once complete (written under a temporary
name, then renamed), and the manifest is written after it, so it never
names a directory still being written.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
from typing import Any, Optional

import torch


def _plain(x, fn):
    """x with every tensor replaced by fn(tensor), named tuples by tuples and
    every dict (an OrderedDict state dict too) by a plain dict: the types
    ``torch.load(weights_only=True)`` takes back. Tensors are visited in a
    fixed order."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _plain(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v, fn) for v in x]
    if isinstance(x, tuple):
        return tuple(_plain(v, fn) for v in x)
    return x


def _host_copies(tensors):
    """Host copies of ``tensors``, bit for bit: per device, every tensor's
    bytes concatenated into one buffer and copied to the host once."""
    out = [None] * len(tensors)
    by_device = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    for idx in by_device.values():
        flat = torch.cat([tensors[i].detach().reshape(-1).view(torch.uint8) for i in idx])
        flat = flat.cpu()
        o = 0
        for i in idx:
            t = tensors[i]
            n = t.numel() * t.element_size()
            out[i] = flat[o:o + n].clone().view(t.dtype).reshape(t.shape)
            o += n
    return out


def to_host(state):
    """The state as plain containers of host tensors (one device-to-host
    copy per device)."""
    tensors = []
    _plain(state, tensors.append)
    host = iter(_host_copies(tensors))
    return _plain(state, lambda t: next(host))


def _restore_into(target, value):
    """``value`` (as loaded) in the structure of ``target``: tensors moved to
    the target tensor's device (shape and dtype must match), named tuples
    rebuilt, numbers cast to the target's type."""
    if isinstance(target, torch.Tensor):
        if value.shape != target.shape or value.dtype != target.dtype:
            raise ValueError(f"checkpoint tensor {tuple(value.shape)} {value.dtype} does "
                             f"not fit the template's {tuple(target.shape)} {target.dtype}")
        return value.to(target.device)
    if isinstance(target, dict):
        return {k: _restore_into(v, value[k]) for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_restore_into(t, v) for t, v in zip(target, value, strict=True)))
    if isinstance(target, (list, tuple)):
        return type(target)(_restore_into(t, v) for t, v in zip(target, value, strict=True))
    if isinstance(target, (bool, int, float, str)):
        return type(target)(value)
    return value


class CheckPointManager:
    """save(step, state, score=None) / load(target, step=None, best=False)."""

    MANIFEST = "checkpoints.json"
    STATE = "state.pt"

    def __init__(self, directory: str, max_to_keep: int = 5,
                 keep_every_n_hours: float = 6.0, best_mode: str = "max",
                 use_async: bool = False):
        if best_mode not in ("max", "min"):
            raise ValueError("best_mode must be 'max' or 'min'")
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.keep_every_n_hours = keep_every_n_hours
        self.best_mode = best_mode
        self.use_async = use_async
        self._thread = None
        self._error = None
        os.makedirs(directory, exist_ok=True)
        self._state = self._read_manifest()

    def wait_until_finished(self):
        """Block until an in-flight async save has committed; re-raise what
        it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- manifest -----------------------------------------------------------
    def _manifest_path(self):
        return os.path.join(self.directory, self.MANIFEST)

    def _read_manifest(self):
        if os.path.exists(self._manifest_path()):
            with open(self._manifest_path()) as f:
                return json.load(f)
        return {"rotating": [], "permanent": [], "best_step": None,
                "best_score": None, "next_save_time": 0.0}

    def _write_manifest(self, text: str):
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, self._manifest_path())

    # -- paths --------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}")

    def _best_path(self) -> str:
        return os.path.join(self.directory, "ckpt-best")

    def _write_dir(self, path: str, host_state):
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(host_state, os.path.join(tmp, self.STATE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    def _commit(self, path, host_state, best, evicted, manifest):
        self._write_dir(path, host_state)
        for old in evicted:
            if os.path.exists(self._path(old)):
                shutil.rmtree(self._path(old))
        if best:
            self._write_dir(self._best_path(), host_state)
        self._write_manifest(manifest)

    def _commit_on_thread(self, *args):
        try:
            self._commit(*args)
        except Exception as e:  # handed to wait_until_finished, which raises it
            self._error = e

    # -- public API ---------------------------------------------------------
    def save(self, step: int, state: Any, score: Optional[float] = None,
             _now: Optional[float] = None) -> str:
        """Write ckpt-{step}; rotate/promote/copy-best per policy. Returns
        the checkpoint path. ``_now`` is injectable for tests."""
        now = time.time() if _now is None else _now
        self.wait_until_finished()  # at most one async save in flight
        host_state = to_host(state)
        path = self._path(step)

        # promotion happens when a checkpoint rotates OUT of the buffer: the
        # first eviction is always promoted, then one per keep_every_n_hours
        # of save time
        st = self._state
        # re-saving a step replaces its entry: a duplicate would later evict
        # and delete the directory the live entry points at
        st["rotating"] = [e for e in st["rotating"] if e[0] != step]
        st["rotating"].append([step, now])
        evicted = []
        while len(st["rotating"]) > self.max_to_keep:
            old_step, old_time = st["rotating"].pop(0)
            if old_time > st["next_save_time"]:
                st["permanent"].append(old_step)
                st["next_save_time"] = (
                    old_time + self.keep_every_n_hours * 3600.0
                )
            else:
                evicted.append(old_step)

        best = False
        if score is not None:
            best = (
                st["best_score"] is None
                or (self.best_mode == "max" and score > st["best_score"])
                or (self.best_mode == "min" and score < st["best_score"])
            )
            if best:
                st["best_score"] = float(score)
                st["best_step"] = step
        args = (path, host_state, best, evicted, json.dumps(st, indent=1))
        if self.use_async:
            self._thread = threading.Thread(target=self._commit_on_thread, args=args)
            self._thread.start()
        else:
            self._commit(*args)
        return path

    def latest_step(self) -> Optional[int]:
        steps = [s for s, _ in self._state["rotating"]] + self._state["permanent"]
        return max(steps) if steps else None

    def best_step(self) -> Optional[int]:
        return self._state["best_step"]

    def _restore(self, path: str, target: Any):
        value = torch.load(os.path.join(path, self.STATE), map_location="cpu",
                           weights_only=True)
        return _restore_into(target, value)

    def load(self, target: Any, step: Optional[int] = None,
             best: bool = False):
        """Restore a checkpoint into the structure of ``target`` (an example
        state: tensors land on the template's devices). Returns (state,
        step), or (None, None) when nothing exists.

        Latest-load is crash-tolerant: an unreadable newest checkpoint is
        skipped (logged) for the next older one. If every existing
        checkpoint fails to restore (a systematic problem, e.g. a changed
        state structure), the last error is re-raised rather than silently
        restarting from scratch."""
        self.wait_until_finished()
        if best:
            if self._state["best_step"] is None:
                return None, None
            return (self._restore(self._best_path(), target),
                    self._state["best_step"])
        if step is not None:
            return self._restore(self._path(step), target), step
        steps = sorted(
            {s for s, _ in self._state["rotating"]}
            | set(self._state["permanent"]), reverse=True)
        last_err = None
        for s in steps:
            try:
                return self._restore(self._path(s), target), s
            except Exception as e:  # an unreadable checkpoint: try the next older one
                last_err = e
                print(f"[checkpoint] skipping unreadable ckpt-{s}: {e!r}",
                      file=sys.stderr)
        if last_err is not None:
            raise last_err
        return None, None


def load_params_from(exp_dir: str, state_template: Any, best: bool = True):
    """Initialise from ANOTHER experiment's checkpoints: ``exp_dir`` may be
    the experiment dir or its checkpoints/ subdir; ``state_template`` is a
    full {params, opt_state, epoch} example. Returns the loaded ``params``
    (the caller starts a FRESH optimiser over them) or None when the
    directory holds no checkpoint. Prefers the best-tracked checkpoint,
    falling back to the latest."""
    path = exp_dir
    if os.path.isdir(os.path.join(exp_dir, "checkpoints")):
        path = os.path.join(exp_dir, "checkpoints")
    mgr = CheckPointManager(path)
    if best and mgr.best_step() is not None:
        state, _ = mgr.load(state_template, best=True)
    else:
        state, _ = mgr.load(state_template)
    return None if state is None else state["params"]
