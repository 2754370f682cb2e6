"""The port's checkpoints and metrics log (utils/checkpoint.py,
utils/logging.py) against the JAX package's.

Each case of the JAX package's ``TestCheckpointManager`` and
``TestCheckpointResave`` runs against the port's manager: rotation with
promotion to permanent by save time, best tracking, the fall-back past a
corrupt latest checkpoint, the same-step re-save, the async round trip.
The same save sequence through both managers gives equal
``checkpoints.json`` contents; ``MetricsWriter`` writes the JAX writer's
JSONL records.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from a_robust_registration_loss_tpu.utils import CheckPointManager as JaxManager
from a_robust_registration_loss_tpu.utils.logging import MetricsWriter as JaxWriter
from a_robust_registration_loss_tpu_torch.train.harness import AdamState
from a_robust_registration_loss_tpu_torch.utils import (CheckPointManager, MetricsWriter,
                                                        load_params_from)
from a_robust_registration_loss_tpu_torch.utils.checkpoint import to_host


def _state(x):
    return {"params": {"w": torch.full((2,), float(x))},
            "opt_state": AdamState(torch.tensor(x, dtype=torch.int32), torch.zeros(2),
                                   torch.full((2,), 0.5 * x)),
            "epoch": x}


def _w(state):
    return float(state["params"]["w"][0])


def test_rotation_and_permanent(tmp_path):
    m = CheckPointManager(str(tmp_path), max_to_keep=2, keep_every_n_hours=1.0)
    t0 = 1000.0
    # promotion happens at eviction: the first evicted checkpoint becomes
    # permanent, then one per n hours of save time
    m.save(0, _state(0), _now=t0)
    m.save(1, _state(1), _now=t0 + 10)
    m.save(2, _state(2), _now=t0 + 20)    # evicts 0 -> permanent
    m.save(3, _state(3), _now=t0 + 30)    # evicts 1 -> deleted
    m.save(4, _state(4), _now=t0 + 3700)  # evicts 2 -> deleted
    m.save(5, _state(5), _now=t0 + 3710)  # evicts 3 -> deleted
    m.save(6, _state(6), _now=t0 + 3720)  # evicts 4 (past the 1 h mark) -> permanent
    names = sorted(os.listdir(str(tmp_path)))
    assert "ckpt-0" in names and "ckpt-4" in names
    assert "ckpt-5" in names and "ckpt-6" in names
    for gone in ("ckpt-1", "ckpt-2", "ckpt-3"):
        assert gone not in names
    assert m.latest_step() == 6
    st, step = m.load(_state(0))
    assert step == 6 and _w(st) == 6.0 and st["epoch"] == 6
    assert isinstance(st["opt_state"], AdamState) and int(st["opt_state"].count) == 6
    st, step = m.load(_state(0), step=4)
    assert _w(st) == 4.0


def test_best_tracking(tmp_path):
    m = CheckPointManager(str(tmp_path), best_mode="min")
    m.save(0, _state(0), score=5.0, _now=0.0)
    m.save(1, _state(1), score=2.0, _now=1.0)
    m.save(2, _state(2), score=3.0, _now=2.0)
    assert m.best_step() == 1
    st, step = m.load(_state(0), best=True)
    assert step == 1 and _w(st) == 1.0


def test_async_save_load_roundtrip_and_best(tmp_path):
    """Saves return after the host copy, wait_until_finished commits, load
    waits for an in-flight save, and the manifest is written only after the
    directory it names."""
    m = CheckPointManager(str(tmp_path), best_mode="min", use_async=True)
    m.save(0, _state(0), score=5.0, _now=0.0)
    m.save(1, _state(1), score=2.0, _now=1.0)  # waits for save 0
    st, step = m.load(_state(0))               # waits for save 1
    assert step == 1 and _w(st) == 1.0
    st, step = m.load(_state(0), best=True)
    assert step == 1 and _w(st) == 1.0
    m.wait_until_finished()
    with open(tmp_path / "checkpoints.json") as f:
        manifest = json.load(f)
    assert [s for s, _ in manifest["rotating"]] == [0, 1] and manifest["best_step"] == 1
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_async_save_copies_once_and_does_not_alias(tmp_path):
    """The save takes its host copy before it returns: changing the tensors
    afterwards does not reach the checkpoint."""
    m = CheckPointManager(str(tmp_path), use_async=True)
    state = _state(3)
    m.save(3, state, _now=0.0)
    state["params"]["w"].fill_(99.0)
    st, _ = m.load(_state(0))
    assert _w(st) == 3.0


def test_load_falls_back_past_corrupt_latest(tmp_path):
    m = CheckPointManager(str(tmp_path))
    m.save(0, _state(0), _now=0.0)
    m.save(1, _state(1), _now=1.0)
    shutil.rmtree(str(tmp_path / "ckpt-1"))  # a torn write of the newest
    (tmp_path / "ckpt-1").mkdir()
    st, step = CheckPointManager(str(tmp_path)).load(_state(0))
    assert step == 0 and _w(st) == 0.0


def test_load_reraises_when_every_checkpoint_fails(tmp_path):
    m = CheckPointManager(str(tmp_path))
    m.save(0, _state(0), _now=0.0)
    wrong = {"params": {"w": torch.zeros(3)}, "opt_state": _state(0)["opt_state"], "epoch": 0}
    with pytest.raises(ValueError, match="does not fit"):
        m.load(wrong)


def test_same_step_resave_no_stale_eviction(tmp_path):
    m = CheckPointManager(str(tmp_path), max_to_keep=2, keep_every_n_hours=1e9)
    m.save(0, _state(0), _now=1.0)
    m.save(0, _state(10), _now=2.0)  # re-save same step
    m.save(1, _state(1), _now=3.0)
    m.save(2, _state(2), _now=4.0)   # evicts step 0 once, not twice
    _, step = m.load(_state(0))
    assert step == 2
    loaded, _ = m.load(_state(0), step=1)
    assert _w(loaded) == 1.0


@pytest.mark.parametrize("use_async", [False, True], ids=["sync", "async"])
def test_manifest_equals_the_jax_managers(tmp_path, use_async):
    """One save sequence (rotation, promotion, a re-save, best changes)
    through both managers: equal checkpoints.json contents."""
    kw = dict(max_to_keep=2, keep_every_n_hours=1.0, best_mode="min")
    port = CheckPointManager(str(tmp_path / "port"), use_async=use_async, **kw)
    ref = JaxManager(str(tmp_path / "jax"), **kw)
    seq = [(0, 0.0, 5.0), (1, 10.0, 4.0), (1, 15.0, 4.5), (2, 20.0, None), (3, 3700.0, 3.0),
           (4, 3710.0, 3.5), (5, 7500.0, 1.0)]
    for step, now, score in seq:
        port.save(step, _state(step), score=score, _now=now)
        ref.save(step, {"params": {"w": jnp.full((2,), float(step))}, "epoch": step},
                 score=score, _now=now)
    port.wait_until_finished()
    with open(tmp_path / "port" / "checkpoints.json") as a, \
            open(tmp_path / "jax" / "checkpoints.json") as b:
        assert json.load(a) == json.load(b)
    dirs = lambda d: sorted(n for n in os.listdir(d) if n.startswith("ckpt-"))
    assert dirs(tmp_path / "port") == dirs(tmp_path / "jax")


def test_load_params_from_prefers_best(tmp_path):
    mgr = CheckPointManager(str(tmp_path / "expA" / "checkpoints"), best_mode="min")
    mgr.save(3, _state(3), score=0.5)
    mgr.save(4, _state(4), score=0.1)  # best
    mgr.save(5, _state(5), score=0.9)
    got = load_params_from(str(tmp_path / "expA"), _state(0))
    assert _w({"params": got}) == 4.0
    assert load_params_from(str(tmp_path / "empty"), _state(0)) is None


def test_to_host_is_bitwise_and_plain():
    state = {"a": torch.tensor([1.5, float("nan"), -0.0]), "b": (torch.tensor(7, dtype=torch.int32),
             [torch.tensor([True, False])]), "n": AdamState(torch.tensor(1), torch.ones(1),
                                                            torch.zeros((2, 2)))}
    host = to_host(state)
    assert type(host["n"]) is tuple and type(host["b"][1]) is list
    for got, want in ((host["a"], state["a"]), (host["b"][0], state["b"][0]),
                      (host["b"][1][0], state["b"][1][0]), (host["n"][2], state["n"].nu)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_metrics_writer_writes_the_jax_writers_records(tmp_path):
    calls = [("add_scalar", ("train/loss", np.float32(0.25), 0)),
             ("add_scalars", ({"loss": 0.5, "nonfinite_steps": 2.0}, 1, "test/")),
             ("add_scalar", ("time/epoch_seconds", 1.75, np.int64(1)))]
    for cls, sub in ((MetricsWriter, "port"), (JaxWriter, "jax")):
        w = cls(str(tmp_path / sub), tensorboard=False)
        for name, args in calls:
            getattr(w, name)(*args)
        w.close()
    recs = {}
    for sub in ("port", "jax"):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            recs[sub] = [json.loads(line) for line in f]
    for r in recs["port"] + recs["jax"]:
        assert isinstance(r.pop("time"), float)
    assert recs["port"] == recs["jax"] and len(recs["port"]) == 4
