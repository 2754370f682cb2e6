"""The trace digest and each per-layer metric's reader on profile
fixtures: traced windows' raw events in the shape the profiler gives them
(``fixtures/*.json``: name, device, start and duration in ns, correlation
id), written out by hand so that each reader's number can be worked out:
two classical epochs replayed from a graph after an eager one (and a host
operator whose id equals a graph launch's), and a DCP epoch's train and
test passes."""

import json
import os

import pytest
from torch.autograd import DeviceType

from portbench import spec
from portbench import trace as TR
from portbench.counts import kernels as K
from portbench.counts import peaks

HERE = os.path.dirname(os.path.abspath(__file__))


class Event:
    """A raw profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, device, start, dur, corr):
        self._v = (name, DeviceType.CUDA if device == "cuda" else DeviceType.CPU, start,
                   dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def load(name):
    with open(os.path.join(HERE, "fixtures", name)) as f:
        return [Event(*e) for e in json.load(f)]


@pytest.fixture(scope="module")
def cells():
    bench = spec.load_benchmark()
    return {w["name"]: spec.Cell(w["name"], bench) for w in bench["workloads"]}


def test_digest_of_the_classical_fixture():
    d = TR.digest(load("classical_window.json"))
    # the window runs from its start mark (1,000 ns) to its end mark (101,000)
    assert d["window_s"] == pytest.approx(100e-6)
    # busy: the eager epoch's kernels 2,000..5,000 and 5,500..6,500, then the
    # replays' 20,000..30,000 and 40,000..50,000; the spin kernel is left out
    assert d["busy_s"] == pytest.approx(24e-6)
    assert len(d["ops"]) == 8 and not any(TR.PRIME_KERNEL in op[0] for op in d["ops"])
    assert [op[3] for op in TR.select(d, "stage1_kernel")] == ["cudaLaunchKernel",
                                                              TR.GRAPH_LAUNCH, TR.GRAPH_LAUNCH]
    assert d["syncs"] == [60_000]


def classical_digest():
    d = TR.digest(load("classical_window.json"))
    d["prepare_ms"] = 412.5
    d["stage1_ops"], d["stage1_bytes"] = K.stage1(1, 20000, 5000, 5000, 4)
    d["resample_ops"], d["resample_bytes"] = K.resample(1, 200000, 100000)
    d["stage1_kernel"], d["resample_kernel"] = "stage1_kernel", "resample_kernel"
    return d


def test_classical_readers(cells):
    cell = cells["classical_demo.full"]
    d = classical_digest()
    got = {m["name"]: cell.reader(m["name"])(d) for m in cell.per_layer}
    # two replays, each: stage 1 4,000 ns, the resampler 2,000, a glue kernel 4,000
    assert got["step_device_ms.register"] == pytest.approx(10e-3)
    assert got["kernels_per_step.register"] == pytest.approx(3.0)
    assert got["prepare_ms.register"] == 412.5
    stage1 = peaks.bound_s(d["stage1_ops"], d["stage1_bytes"])
    assert got["stage1_roofline.register"] == pytest.approx(100 * 3 * stage1 / 11e-6)
    resample = peaks.bound_s(d["resample_ops"], d["resample_bytes"])
    assert got["resample_roofline.register"] == pytest.approx(100 * 3 * resample / 5e-6)
    ops = 3 * d["stage1_ops"] + 3 * d["resample_ops"]
    assert got["step_mfu.register"] == pytest.approx(100 * ops / (100e-6 * peaks.FP32_OPS))
    assert got["device_idle.register"] == pytest.approx(76.0)


def test_refine_readers(cells):
    cell = cells["classical_demo.refine"]
    got = {m["name"]: cell.reader(m["name"])(classical_digest()) for m in cell.per_layer}
    assert got == {"prepare_ms.refine": 412.5, "device_idle.refine": pytest.approx(76.0)}


def test_dcp_readers(cells):
    cell = cells["dcp_v2.train_b4"]
    d = TR.digest(load("dcp_window.json"))
    d.update(train_steps=2, train_flops=4.0e9, eval_flops=1.0e9,
             stage1_kernel="stage1_kernel", resample_kernel="resample_kernel")
    d["stage1_ops"], d["stage1_bytes"] = K.stage1(4, 15000, 1024, 1024, 4)
    d["resample_ops"], d["resample_bytes"] = K.resample(4, 150000, 300000)
    got = {m["name"]: cell.reader(m["name"])(d) for m in cell.per_layer}
    # the train pass (marks at 10,000 and 50,000): 2 steps of stage 1 (5,000
    # ns), the resampler (1,000) and a product (3,000); a wait each step; the
    # test pass's kernel and its wait come after the eval mark
    assert got["step_device_ms.train"] == pytest.approx(9e-3)
    assert got["host_waits_per_step.train"] == pytest.approx(1.0)
    stage1 = peaks.bound_s(d["stage1_ops"], d["stage1_bytes"])
    assert got["stage1_roofline.train"] == pytest.approx(100 * 2 * stage1 / 10e-6)
    resample = peaks.bound_s(d["resample_ops"], d["resample_bytes"])
    assert got["resample_roofline.train"] == pytest.approx(100 * 2 * resample / 2e-6)
    flops = 4.0e9 + 1.0e9 + 2 * d["stage1_ops"] + 2 * d["resample_ops"]
    assert got["step_mfu.train"] == pytest.approx(100 * flops / (80e-6 * peaks.FP32_OPS))
    assert got["device_idle.train"] == pytest.approx(100 * (1 - 20e-6 / 80e-6))


def test_a_reader_finds_nothing_in_an_empty_window(cells):
    empty = TR.digest([Event("portbench.window_start", "cpu", 0, 0, 1),
                       Event("portbench.window_end", "cpu", 1000, 0, 2)])
    empty.update(stage1_kernel="stage1_kernel", resample_kernel="resample_kernel")
    for name in ("classical_demo.full", "classical_demo.refine", "dcp_v2.train_b4"):
        cell = cells[name]
        for m in cell.per_layer:
            if not m["name"].startswith("prepare_ms."):
                assert cell.reader(m["name"])(empty) is None, m["name"]


def test_breakdown_names_the_busiest_operations_and_the_longest_gaps():
    b = TR.breakdown(TR.digest(load("classical_window.json")))
    assert b["device_ops"][0][0] == "stage1_kernel"
    assert b["device_ops"][0][1] == pytest.approx(11e-6)
    # the longest gap, 50,000..101,000, falls while the host waits on the card
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(51e-6)]
    assert len(b["device_ops"]) <= TR.TOP and len(b["idle_gaps"]) <= TR.TOP


def test_a_trace_that_lost_records_prints_no_result(monkeypatch, capsys):
    """A traced window lacking launches that the program counted reads its
    metrics wrong: the run exits with another code than 0 and no result."""
    import torch

    from portbench import run
    from portbench.runners import classical

    d = classical_digest()
    traced = {k: len(TR.select(d, k)) for k in ("stage1_kernel", "resample_kernel")}
    d["counted"] = dict(traced, stage1_kernel=traced["stage1_kernel"] + 1)
    assert not TR.complete(d)
    res = dict(e2e={}, digest=d, checks={}, attempted=1, failed=0, memory_peak_bytes=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(classical, "run", lambda *args: res)
    code = run.main(["--workload", "classical_demo.full", "--seed", "1", "--seconds", "1",
                     "--trace", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "lost records" in out.err
    d["counted"] = traced
    assert TR.complete(d) and run.lost_records(res) is None


def test_metrics_of_one_quantity_share_its_reader(cells):
    shared = {("classical_demo.full", "device_idle.register"),
              ("classical_demo.refine", "device_idle.refine"),
              ("dcp_v2.train_b4", "device_idle.train")}
    readers = {cells[c].reader(m) for c, m in shared}
    d = TR.digest(load("dcp_window.json"))
    assert len({r(d) for r in readers}) == 1
    assert not os.path.exists(os.path.join(spec.HERE, "metrics", "device_idle.train.py"))
