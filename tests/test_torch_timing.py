"""The port's step timer and trace scope (utils/timing.py) on the CPU:
``StepTimer.summary`` has the JAX package's keys and drops the warm-up
steps; a CPU ``sync_on`` waits for nothing; ``trace(None)`` is a no-op and
``trace(dir)`` writes a Chrome trace there."""

import json
import os

import pytest
import torch

from a_robust_registration_loss_tpu_torch import utils
from a_robust_registration_loss_tpu_torch.utils import timing


def test_summary_keys_and_warmup(monkeypatch):
    clock = iter([0.0, 10.0, 10.0, 11.0, 11.0, 13.0, 13.0, 16.0, 16.0, 20.0])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("a CPU step waited for a card"))
    timer = utils.StepTimer(warmup=1)
    assert timer.summary() == {}
    for _ in range(5):
        with timer.step(sync_on={"x": [torch.zeros(2)], "y": 3}):
            pass
    assert timer.times == [10.0, 1.0, 2.0, 3.0, 4.0]
    assert timer.summary() == {"steps": 4, "mean_s": 2.5, "p50_s": 3.0, "p90_s": 4.0,
                               "iters_per_sec": 0.4}
    short = timing.StepTimer(warmup=8)
    short.times = [2.0, 1.0]
    assert short.summary()["steps"] == 2  # all warm-up: the summary keeps them


def test_trace_none_is_a_noop_and_a_dir_gets_a_trace(tmp_path):
    with utils.trace(None):
        torch.ones(3).sum()
    logdir = str(tmp_path / "tr")
    with utils.trace(logdir):
        (torch.ones(8) * 2).sum()
    (name,) = os.listdir(logdir)
    assert name.startswith("trace_") and name.endswith(".json")
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)
