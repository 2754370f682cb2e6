"""One run of one cell of the port's benchmark on the card(s) of this
machine:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It reads ``BENCHMARK.json``, finds the cell's
configuration, traffic and limits under ``portbench/`` (``spec.py``), and
hands them to the configuration's runner, which sets up, measures for
``--seconds`` (with ``--trace 1``: a traced window, and the per-layer
metrics instead of the end-to-end ones), and then compares what the timed
path produced with the plain reference.

The last lines of standard error are the numbers compared, each beside its
limit; the last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), with ``--trace 1`` a ``breakdown``, and
last ``checks``, the numbers compared. It exits with another code than 0,
and prints no result, without enough CUDA devices, when a module of JAX or
of the JAX package is loaded once the window has closed, when a traced
window lacks launches that the program counted, or when the port is not
beside it.
"""

import time

T0 = time.perf_counter()  # set-up counts from here: imports, the card, warm-up

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# the profiler's device-record buffer, raised to 4 GB: a traced window of
# two whole classical registrations holds about two million kernels (each
# traced run checks its records against the program's launch counters)
KINETO_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kineto.conf")

# top-level module names that must not be loaded: JAX, and the JAX package
# (the port's own name begins with it, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "a_robust_registration_loss_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def lost_records(res):
    """Where the traced window lacks launches that the program's counters
    counted (the profiler drops records), what was counted and what was
    traced; None for a whole trace or an untraced run."""
    from portbench import trace as TR

    d = res.get("digest")
    if d is None or TR.complete(d):
        return None
    return d["counted"], {k: len(TR.select(d, k)) for k in d["counted"]}


def result_line(cell, res, trace: bool, device: dict):
    """The result's JSON object, its keys in the order above."""
    from portbench import trace as TR

    if trace:
        d = res["digest"]
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(d)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = dict(device, busy_s=d["busy_s"], window_s=d["window_s"])
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = res["checks"]
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if trace:
        out["breakdown"] = TR.breakdown(res["digest"])
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("KINETO_CONFIG", KINETO_CONFIG)
    from portbench import spec

    cell = spec.Cell(args.workload, spec.load_benchmark())
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = cell.runner().run(cell, args.seed, args.seconds, bool(args.trace), T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    lost = lost_records(res)
    if lost:
        print(f"portbench: the trace lost records, so its metrics would read wrong: "
              f"launches counted {lost[0]}, traced {lost[1]}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"]),
              "power_limit": power_limit()}
    out = result_line(cell, res, bool(args.trace), device)
    print(f"portbench: the reference's comparison took {res['check_s']!r} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
