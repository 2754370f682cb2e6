"""``BENCHMARK.json`` against the rules its readers hold it to (keys,
names, units, bounds, sizes), every name in it resolved to its files, and
a cell made only of new files found."""

import json
import os
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= len(bench["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_entries(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    for group in (bench["end_to_end"] + bench["per_layer"], bench["workloads"],
                  bench["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert all(1 <= len(c[k]) <= 200 and "\n" not in c[k] for k in ("why", "source"))
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in bench["end_to_end"])


def test_every_cell_resolves_to_its_files(bench):
    for w in bench["workloads"]:
        cell = spec.Cell(w["name"], bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(cell.reader(m["name"]))
        assert hasattr(cell.runner(), "run")
        assert cell.limits and all(float(v) >= 0 for v in cell.limits.values())


def test_every_config_reports_every_reduced_key_and_states_its_precision(bench):
    for c in bench["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert "runner" in conf and "precision" in conf
        assert all(k in conf for k in c["reduced"])


def test_a_cell_made_only_of_new_files_is_found(tmp_path, bench):
    """A later PR adds a configuration, its traffic, limits and a metric as
    new files and entries; the harness finds them without an edit."""
    root = tmp_path / "checkout"
    here = root / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "configs" / "toy.json").write_text(json.dumps({"runner": "classical", "n": 1}))
    (here / "traffic" / "tiny.json").write_text(json.dumps({"points": 64, "noise": 0.01}))
    (here / "limits" / "toy.json").write_text(json.dumps({"loss_gap": 1e-6}))
    (here / "metrics" / "toy_ms.step.py").write_text("def read(d):\n    return d.get('x')\n")
    b = dict(bench)
    b["configs"] = bench["configs"] + [{"name": "toy", "source": "a paper", "why": "a test",
                                        "file": "portbench/configs/toy.json", "reduced": []}]
    b["workloads"] = bench["workloads"] + [{"name": "toy.tiny", "config": "toy",
                                            "traffic": "tiny", "chips": 1, "why": "a test"}]
    b["per_layer"] = bench["per_layer"] + [{"name": "toy_ms.step", "unit": "ms",
                                            "better": "lower", "source": "device_trace",
                                            "layer": "toy", "moves": "setup_s",
                                            "workloads": ["toy.tiny"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.Cell("toy.tiny", spec.load_benchmark(str(root)), here=str(here))
    assert cell.config == {"runner": "classical", "n": 1}
    assert cell.traffic["points"] == 64 and cell.limits == {"loss_gap": 1e-6}
    assert [m["name"] for m in cell.per_layer] == ["toy_ms.step"]
    assert cell.reader("toy_ms.step")({"x": 3.5}) == 3.5
    assert cell.runner().__name__ == "portbench.runners.classical"
