"""The readers of the program's own spans (``portbench/spans.py`` and the
``program_span`` metrics) on a profile fixture, ``fixtures/spans_window.json``:
raw events in the shape the profiler gives them (name, device, start and
duration in ns, correlation id), written out by hand so that each number
can be worked out: a classical request's parts, then a DCP epoch's passes,
solves and checkpoint, with an eval span and the epoch's root cut by the
window's end."""

import json
import os

import pytest
from torch.autograd import DeviceType

from portbench import spans as S
from portbench import spec
from portbench import trace as TR

HERE = os.path.dirname(os.path.abspath(__file__))
CELLS = ("classical_demo.full", "classical_demo.refine", "dcp_v2.train_b4", "dcp_v2.train_b32")


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


def spans_digest():
    with open(os.path.join(HERE, "fixtures", "spans_window.json")) as f:
        d = TR.digest([Event(*e) for e in json.load(f)])
    d["train_steps"] = 2
    return d


@pytest.fixture(scope="module")
def cells():
    bench = spec.load_benchmark()
    return {name: spec.Cell(name, bench) for name in CELLS}


def test_span_readers(cells):
    d = spans_digest()
    got = {}
    for cell in cells.values():
        got.update({m["name"]: cell.reader(m["name"])(d) for m in cell.per_layer
                    if m["source"] == "program_span"})
    # one request (2,000..60,000): its prepare 18,000 ns (the one at 100..900
    # lies before the window), a capture of 9,000 in the first block, a
    # release of 9,000
    assert got["prepare_span_ms.register"] == pytest.approx(18e-3)
    assert got["capture_ms.register"] == pytest.approx(9e-3)
    assert got["release_ms.register"] == pytest.approx(9e-3)
    # the eval pass 121,000..150,000; the second, open at the window's end
    # (190,000..230,000), is not read; the checkpoint 151,000..170,000
    assert got["eval_ms.train"] == pytest.approx(29e-3)
    assert got["checkpoint_stall_ms.train"] == pytest.approx(19e-3)
    # the solves in the train pass: 80,000..85,000 with 1,000 ns of the SVD
    # busy, 100,000..104,000 idle: 8,000 ns idle over 2 steps
    assert got["solve_idle_ms.train"] == pytest.approx(4e-3)
    # idle 199,000 - 82,000 busy = 117,000 ns; outside every span but the
    # roots: 1,000 x 6 (the edges of the request's parts and of the passes),
    # 16,000 (the request's end to the train pass), 30,000 (the checkpoint
    # to the window's end)
    for cell in ("register", "train"):
        assert got[f"idle_unspanned.{cell}"] == pytest.approx(100 * 52_000 / 117_000)
    assert len(got) == 8


def test_a_span_is_read_only_inside_the_window():
    d = spans_digest()
    assert S.spans(d, "arrl.fit.epoch") == []  # cut by the window's end
    assert S.spans(d, "arrl.fit.eval") == [(121_000, 150_000)]
    assert S.spans(d, "arrl.classical.prepare") == [(2_000, 20_000)]
    assert len(S.spans(d)) == 11 and len(S.spans(d, but=S.ROOTS)) == 10
    assert S.idle_ns([(0, 10)], []) == 10
    assert S.idle_ns([(80_000, 85_000), (84_000, 90_000)], S.busy(d)) == 10_000 - 1_000 - 4_000


def test_breakdown_puts_idle_gaps_down_to_spans():
    labels = {round(t * 1e9): name for name, t in TR.breakdown(spans_digest())["idle_gaps"]}
    assert labels[40_000] == "arrl.fit.epoch"                      # 160,000..200,000
    assert labels[33_000] == "arrl.classical.run"                  # 39,000..72,000
    assert labels[14_000] == "arrl.classical.prepare"              # 8,000..22,000
