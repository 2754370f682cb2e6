"""The port's spans (``utils/timing.py:span``) on the CPU: profiler ranges
at the request layer (``train/classical.py``) and the trainer and step
layer (``train/harness.py``), read back from the profiler's raw events and
nested by their intervals on the host thread.

- A classical registration through the graph's loop ("static" mode, its
  stand-in on the CPU), single and batched: one root holding the prepare,
  a block per ``log_every`` epochs with the capture in the first, a fetch
  per block and the release.
- ``Trainer.fit`` over a ``DeviceCache`` (the scanned epoch): per epoch a
  root holding the train pass, the eval pass and the checkpoint, and one
  solve per step of DCP's split inside the passes; a forward span a piece,
  and in a train step its backward and update after them.
- With no profiler a span is one shared no-op that enters no profiler
  range; with one, a function-scope range; a span closes when its body
  raises; ``trace``'s Chrome trace holds the spans.
"""

import json
import math
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from a_robust_registration_loss_tpu_torch import utils
from a_robust_registration_loss_tpu_torch.data import dataset as DS
from a_robust_registration_loss_tpu_torch.models import dcp as D
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.train import classical as TC
from a_robust_registration_loss_tpu_torch.train import dcp as TD
from a_robust_registration_loss_tpu_torch.train import harness as H
from a_robust_registration_loss_tpu_torch.train import losses as LS
from a_robust_registration_loss_tpu_torch.utils import timing

torch.set_num_threads(1)

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "a_robust_registration_loss_tpu_torch")
CFG = TC.ClassicalConfig(n_epochs=5, n_lines=64, num_sample=32, log_every=2)
CLASSICAL = ("arrl.classical.run", "arrl.classical.prepare", "arrl.classical.block",
             "arrl.classical.capture", "arrl.classical.fetch", "arrl.classical.release")


def _cloud(rng, n=200):
    x = rng.standard_normal((n, 3)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True) * np.float32([1.0, 0.7, 0.5])


def _pair(rng, angle=0.2):
    src = _cloud(rng)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    return src, (src @ R + np.float32([0.05, -0.02, 0.01])).astype(np.float32), R


def _spans(prof):
    """The profile's ``arrl.`` ranges as (name, start_ns, end_ns), by start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("arrl.")), key=lambda s: (s[1], -s[2]))


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _within(spans, name, parent):
    return [s for s in spans if s[0] == name and _inside(s, parent)]


def _static(monkeypatch):
    """``run`` and ``run_batch`` through the graph's loop on the CPU."""
    loop = TC._loop
    monkeypatch.setattr(TC, "_loop", lambda *args: loop(*args, mode="static"))


@pytest.mark.parametrize("batched", [False, True], ids=["run", "run_batch"])
def test_a_registration_nests_its_spans(batched, monkeypatch):
    _static(monkeypatch)
    rng = np.random.default_rng(5)
    src, tar, _ = _pair(rng)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if batched:
            TC.run_batch(np.stack([src, tar]), np.stack([tar, src]), CFG, device="cpu")
        else:
            TC.run(src, tar, CFG, device="cpu")
    spans = _spans(prof)
    (root,) = [s for s in spans if s[0] == "arrl.classical.run"]
    assert all(_inside(s, root) for s in spans)
    blocks = _within(spans, "arrl.classical.block", root)
    assert len(blocks) == math.ceil(CFG.n_epochs / CFG.log_every) == 3
    assert len(_within(spans, "arrl.classical.prepare", root)) == 1
    assert len(_within(spans, "arrl.classical.capture", blocks[0])) == 1
    assert len(_within(spans, "arrl.classical.capture", root)) == 1
    fetches = _within(spans, "arrl.classical.fetch", root)
    assert len(fetches) == len(blocks)
    # a block's fetch comes after the next block (one block late), outside it
    assert not any(_inside(f, b) for f in fetches for b in blocks)
    assert fetches[0][1] >= blocks[1][2]
    (release,) = _within(spans, "arrl.classical.release", root)
    assert release[1] >= blocks[-1][2]
    assert {s[0] for s in spans} == set(CLASSICAL)


class Items:
    """Pairs in the dataset contract's DCP form (a dataset a ``Loader``
    takes)."""

    corrupt = None

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _dcp_items(rng, n, F=16):
    items = []
    for _ in range(n):
        src, tar, R = _pair(rng, rng.uniform(0.1, 0.4))
        src, tar = src - src.mean(0), tar - tar.mean(0)
        T = np.zeros(3, np.float32)
        neis = [G.sample_neighs(torch.as_tensor(c), F, 3).numpy() for c in (src, tar)]
        items.append({
            "points_src_sample": src, "points_tar_sample": tar,
            "normals_src": np.zeros_like(src), "normals_tar": np.zeros_like(tar),
            "points_based_neighs_src": neis[0].reshape(-1, 3),
            "points_based_neighs_tar": neis[1].reshape(-1, 3),
            "tar_box": G.bounding_box_corners(torch.as_tensor(tar)[None])[0].numpy(),
            "centers": tar.mean(0), "R": R.T.copy(), "T": T, "R_inv": R.copy(), "T_inv": T,
            "igt": np.eye(4, dtype=np.float32)})
    return items


def test_a_fit_nests_its_spans(tmp_path):
    rng = np.random.default_rng(8)
    train = DS.DeviceCache(DS.Loader(Items(_dcp_items(rng, 5)), 2, shuffle=True,
                                     drop_last=True, seed=4), device="cpu")
    test = DS.DeviceCache(DS.Loader(Items(_dcp_items(rng, 2)), 1, shuffle=False,
                                    drop_last=False, seed=4), device="cpu")
    cfg = TD.DCPTrainConfig(
        lr=1e-4, loss=LS.LossConfig(n_lines=64),
        model=D.DCPConfig(emb_nn="pointnet", emb_dims=16, ff_dims=32, n_heads=2),
        fit=H.FitConfig(epochs=2, exp_dir=str(tmp_path), log_tensorboard=False, seed=3,
                        async_checkpoints=False))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, history = TD.train(cfg, train, test, log=lambda m: None, device="cpu")
    assert len(history) == 2
    spans = _spans(prof)
    epochs = [s for s in spans if s[0] == "arrl.fit.epoch"]
    assert len(epochs) == 2
    assert all(any(_inside(s, e) for e in epochs) for s in spans)
    for epoch in epochs:
        (tr,) = _within(spans, "arrl.fit.train", epoch)
        (ev,) = _within(spans, "arrl.fit.eval", epoch)
        (ck,) = _within(spans, "arrl.fit.checkpoint", epoch)
        assert tr[2] <= ev[1] and ev[2] <= ck[1]
        # DCP's split: one solve (the SVD head) between its two pieces, a step;
        # 2 train steps (5 pairs in batches of 2, the last dropped), 2 test steps
        assert len(TD.train_split(cfg).pieces) - 1 == 1
        assert len(_within(spans, "arrl.step.solve", tr)) == len(train) == 2
        assert len(_within(spans, "arrl.step.solve", ev)) == len(test) == 2
    assert len([s for s in spans if s[0] == "arrl.step.solve"]) == 8


def test_a_fit_step_nests_its_forward_backward_and_update(tmp_path):
    """Each split step of a pass: an ``arrl.step.forward`` a piece, the
    solves between them; a train step then its ``arrl.step.backward`` and
    its ``arrl.step.update``, in that order; a test step no backward and no
    update."""
    rng = np.random.default_rng(10)
    train = DS.DeviceCache(DS.Loader(Items(_dcp_items(rng, 4)), 2, shuffle=True,
                                     drop_last=True, seed=4), device="cpu")
    test = DS.DeviceCache(DS.Loader(Items(_dcp_items(rng, 2)), 1, shuffle=False,
                                    drop_last=False, seed=4), device="cpu")
    cfg = TD.DCPTrainConfig(
        lr=1e-4, loss=LS.LossConfig(n_lines=64),
        model=D.DCPConfig(emb_nn="pointnet", emb_dims=16, ff_dims=32, n_heads=2),
        fit=H.FitConfig(epochs=1, exp_dir=str(tmp_path), log_tensorboard=False, seed=3,
                        async_checkpoints=False))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TD.train(cfg, train, test, log=lambda m: None, device="cpu")
    spans = _spans(prof)
    (tr,) = [s for s in spans if s[0] == "arrl.fit.train"]
    (ev,) = [s for s in spans if s[0] == "arrl.fit.eval"]
    pieces = len(TD.train_split(cfg).pieces)
    assert pieces == len(TD.eval_split(cfg).pieces) == 2
    parts = ("arrl.step.forward", "arrl.step.solve", "arrl.step.backward", "arrl.step.update")
    steps = [s for s in spans if s[0] in parts and _inside(s, tr)]
    # 2 train steps: forward, solve, forward, backward, update each
    one = ["arrl.step.forward", "arrl.step.solve"] * (pieces - 1) + [
        "arrl.step.forward", "arrl.step.backward", "arrl.step.update"]
    assert [s[0] for s in steps] == one * len(train) == one * 2
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))  # one after another
    tests = [s[0] for s in spans if s[0] in parts and _inside(s, ev)]
    assert tests == ["arrl.step.forward", "arrl.step.solve", "arrl.step.forward"] * len(test)
    assert len([s for s in spans if s[0] == "arrl.step.backward"]) == len(train)


def test_off_a_span_is_one_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", refuse)
    assert not torch._C._autograd._profiler_enabled()
    off = {id(timing.span(name)) for name in timing.SPANS}
    assert off == {id(timing.span("arrl.classical.run"))}
    with timing.span("arrl.classical.run") as inside:
        assert inside is None
    # a whole registration and its blocks, with no profiler: no range entered
    rng = np.random.default_rng(6)
    _static(monkeypatch)
    src, tar, _ = _pair(rng)
    params, hist = TC.run(src, tar, CFG, device="cpu")
    assert params.shape == (6,) and len(hist["loss"]) == CFG.n_epochs


def test_on_a_span_is_a_function_scope_profiler_range():
    """Not ``record_function``'s user annotation, which the profiler
    mirrors on the card as an event over the kernels launched inside."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = timing.span("arrl.step.solve")
        assert isinstance(s, torch._C._profiler._RecordFunctionFast)
        with s:
            torch.ones(4).sum()
    ((name, a, b),) = _spans(prof)
    assert name == "arrl.step.solve" and b > a
    (event,) = [e for e in prof.events() if e.name == "arrl.step.solve"]
    assert [c.name for c in event.cpu_children] == ["aten::ones", "aten::sum"]


def test_a_span_closes_when_its_body_raises(monkeypatch):
    rng = np.random.default_rng(7)
    src, tar, _ = _pair(rng)
    data = TC.prepare_pair(src, tar, CFG, "cpu")
    gen = torch.Generator().manual_seed(CFG.seed)
    step = TC.make_step(CFG, data)
    calls = []

    def failing(carry, u4):
        calls.append(1)
        if len(calls) == 3:
            raise FloatingPointError("the third epoch")
        return step(carry, u4)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(FloatingPointError):
            TC._loop(CFG, failing, TC.init_twist(gen), data["src"], gen, None, mode="static")
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names.count("arrl.classical.release") == 1
    # the failing epoch's block closed at the raise, before the release
    blocks = [s for s in spans if s[0] == "arrl.classical.block"]
    (release,) = [s for s in spans if s[0] == "arrl.classical.release"]
    assert len(blocks) == 2 and blocks[-1][2] <= release[1]


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path, monkeypatch):
    _static(monkeypatch)
    rng = np.random.default_rng(9)
    src, tar, _ = _pair(rng)
    logdir = str(tmp_path / "tr")
    with utils.trace(logdir):
        TC.run(src, tar, CFG, device="cpu")
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    found = {e["name"] for e in events if e.get("name", "").startswith("arrl.")}
    assert found == set(CLASSICAL)


def test_every_span_in_the_package_is_named_in_spans():
    used = set()
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    used |= set(re.findall(r'\bspan\("([^"]+)"\)', fh.read()))
    assert used == set(timing.SPANS)
    assert all(n.startswith("arrl.") for n in timing.SPANS)
