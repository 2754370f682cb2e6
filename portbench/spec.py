"""``BENCHMARK.json`` and the files its names lead to.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:

- configuration ``<c>``: ``configs/<c>.json`` (the ``file`` of its entry),
  whose ``runner`` names ``runners/<runner>.py``, and ``limits/<c>.json``,
  the limits of the comparison that decides ``correct``;
- traffic ``<t>``: ``traffic/<t>.json``;
- per-layer metric ``<m>``: ``metrics/<m>.py``, a reader with
  ``read(digest) -> float or None``; where there is none, the reader of
  its quantity, the name before the first dot (``metrics/device_idle.py``
  for ``device_idle.train``), which metrics that read one quantity alike
  in cells of different end-to-end metrics share.

A cell, a configuration or a metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

from portbench import traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, workload: str, end_to_end: set) -> bool:
    """Whether a metric is reported in a cell: listed there, or, without a
    ``workloads`` key, wherever its end-to-end metric is (a per-layer one)
    or everywhere (an end-to-end one)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, name: str, bench: dict, here: str = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config_name = conf["name"]
        with open(os.path.join(os.path.dirname(here), conf["file"])) as f:
            self.config = json.load(f)
        self.traffic = traffic.load(self.entry["traffic"], here)
        with open(os.path.join(here, "limits", f"{self.config_name}.json")) as f:
            self.limits = json.load(f)
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name, set())]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
        self.here = here

    def runner(self):
        return importlib.import_module(f"portbench.runners.{self.config['runner']}")

    def reader(self, metric: str):
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        if not os.path.exists(path):
            path = os.path.join(self.here, "metrics", f"{metric.split('.')[0]}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
