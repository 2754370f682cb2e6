"""Anomaly debugging: the trainers' ``--debug_nans`` and ``--debug``.

Port of ``a_robust_registration_loss_tpu/utils/debug.py``. There,
``jax_debug_nans`` raises ``FloatingPointError`` at the first NaN any
primitive produces, in the forward as in the backward. PyTorch's anomaly
mode sees only the backward, so NaN checking here is three checks:

- autograd's anomaly mode with ``check_nan``: a backward node that returns
  NaN raises, naming the node (``grad`` turns its ``RuntimeError`` into a
  ``FloatingPointError``);
- a forward hook on every module: a module whose output holds a NaN raises
  ``FloatingPointError`` naming the module (by its name in the model that
  ``name_modules`` registered, else by its class);
- ``check_nans`` on the loss (``train/harness.py:guarded_update`` calls it):
  a NaN loss raises.

So with the checks on, a poisoned batch raises where the guarded step would
skip it, as the JAX CLIs do. Each check waits for the device; it is a
debugging mode. ``debugger()`` and ``install_pdb_excepthook`` post-mortem
into pdb on a ``FloatingPointError`` or ``RuntimeError``, skipped when a
debugger is already tracing, as the JAX package does.
"""

from __future__ import annotations

import contextlib
import pdb
import sys
import traceback
import weakref

import torch

_state = {"on": False, "hook": None, "anomaly": None}
_names: "weakref.WeakKeyDictionary[torch.nn.Module, str]" = weakref.WeakKeyDictionary()


@contextlib.contextmanager
def debugger(enabled: bool = True):
    """Post-mortem pdb on numeric anomalies escaping the block."""
    if not enabled:
        yield
        return
    try:
        yield
    except (FloatingPointError, RuntimeError) as e:
        traceback.print_exc()
        print(e)
        if sys.gettrace() is None:
            pdb.post_mortem()
        raise


def nan_checks_on() -> bool:
    return _state["on"]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def check_nans(what: str, *values):
    """With the checks on, raise ``FloatingPointError`` naming ``what`` if
    any floating tensor in ``values`` (nested lists, tuples and dicts too)
    holds a NaN. With them off, return at once without reading the
    tensors."""
    if not _state["on"]:
        return
    for t in _tensors(values):
        if t.is_floating_point() and bool(torch.isnan(t.detach()).any()):
            raise FloatingPointError(f"NaN in {what} (shape {tuple(t.shape)}, {t.dtype})")


def _forward_hook(module, args, output):
    name = _names.get(module)
    what = (f"the output of module {name!r} ({type(module).__name__})" if name
            else f"the output of a {type(module).__name__}")
    check_nans(what, output)


def name_modules(model: torch.nn.Module):
    """Register the names of ``model``'s modules for the forward check's
    messages."""
    for name, module in model.named_modules():
        _names[module] = name or type(model).__name__


def enable_anomaly_detection(with_pdb: bool = False):
    """Turn the NaN checks on for the process; returns a context manager to
    wrap the training entry (a pass-through unless with_pdb)."""
    if not _state["on"]:
        _state["anomaly"] = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        _state["hook"] = torch.nn.modules.module.register_module_forward_hook(_forward_hook)
        _state["on"] = True
    return debugger(with_pdb)


def disable_anomaly_detection():
    """Turn the NaN checks off again, anomaly mode back to what it was."""
    if _state["on"]:
        _state["hook"].remove()
        torch.autograd.set_detect_anomaly(*_state["anomaly"])
        _state.update(on=False, hook=None, anomaly=None)


@contextlib.contextmanager
def anomaly_detection(enabled: bool = True):
    """The NaN checks on inside the block (if ``enabled``), as they were
    after it."""
    was = _state["on"]
    if enabled:
        enable_anomaly_detection()
    try:
        yield
    finally:
        if enabled and not was:
            disable_anomaly_detection()


def grad(outputs, inputs, **kwargs):
    """``torch.autograd.grad``; with the checks on, anomaly mode's error for
    a backward node that returned NaN comes out as ``FloatingPointError``
    (naming the node)."""
    try:
        return torch.autograd.grad(outputs, inputs, **kwargs)
    except RuntimeError as e:
        if _state["on"] and "nan values" in str(e):
            raise FloatingPointError(str(e)) from e
        raise


def install_pdb_excepthook():
    """Process-wide pdb post-mortem on numeric anomalies: chains the
    existing excepthook, then enters pdb for FloatingPointError or
    RuntimeError when no debugger is already tracing."""
    old = sys.excepthook
    if getattr(old, "arrl_pdb_hook", False):
        return

    def hook(tp, val, tb):
        old(tp, val, tb)
        if issubclass(tp, (FloatingPointError, RuntimeError)) and sys.gettrace() is None:
            pdb.post_mortem(tb)

    hook.arrl_pdb_hook = True
    sys.excepthook = hook
