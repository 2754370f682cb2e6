#!/usr/bin/env python3
"""Which device records torch.profiler loses, and when, on one CUDA card.

    python3 tools/tracer_records.py [--out build/tracer_records.json]

Times the row gather's forward kernel the way ``chip_smoke.py:kernel_ms``
does (20 launches at RPM-Net's grouping shape, (B, N, C, Q) = (4, 1,024,
6, 65,536), inside one profiler window closed after a
``torch.cuda.synchronize()``) at points of one process's life:

1. fresh, before anything else has traced;
2. after ``--burn`` seconds of other profiled work (windows of
   thousands of small launches each, as the script's path profiles are);
3. after ``--idle`` seconds with no profiler and no work;
4. after the idle time, windows in turns without a remedy, with
   ``--pad_ms`` of host wait after the window opens (before the first
   timed launch) and after the closing synchronize, and primed: ``PRIME``
   spin kernels of ``PRIME_CYCLES`` clock cycles each
   (``torch.cuda._sleep``) launched inside the window before the timed
   launches, the remedy ``chip_smoke.py:prime`` takes (with 64 shorter
   ones).

For each window it counts the gather's device records in the raw kineto
results (``prof.profiler.kineto_results.events()``) and in the
``FunctionEvent`` list (``prof.events()``), and the host's launch records
(the CUDA runtime's ``cudaLaunchKernel``), matched by correlation id. For
each launch whose device record is missing it gives its position in the
window and the time from its host record to the window's last host
record, and for each matched pair the time from the end of the host's
launch call to the kernel's start: negative where the device's clock, as
the tracer maps it onto the host's, runs behind. The raw events of every
window go to ``--out`` as JSON. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 1024, 6, 65536)
REPS = 20
PRIME, PRIME_CYCLES = 16, 1_000_000  # spin kernels that open a primed window


def _raw(e):
    return dict(name=e.name(), device=str(e.device_type()).split(".")[-1],
                start_ns=e.start_ns(), end_ns=e.end_ns(), corr=e.correlation_id(),
                linked=e.linked_correlation_id(), stream=e.device_resource_id())


def window(torch, call, pad_ms=0.0, primed=False):
    """One kernel_ms-style window of REPS calls, padded by ``pad_ms`` of
    host wait at both ends, or primed by spin kernels: the records seen and
    lost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_ms / 1e3)
        for _ in range(PRIME if primed else 0):
            torch.cuda._sleep(PRIME_CYCLES)
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
        time.sleep(pad_ms / 1e3)
    raw = [_raw(e) for e in prof.profiler.kineto_results.events()]
    dev = [r for r in raw if r["device"] == "CUDA" and "gather_fwd" in r["name"]]
    launches = [r for r in raw if r["name"].startswith("cudaLaunchKernel")][
        PRIME if primed else 0:]
    fe = sum(1 for e in prof.events()
             if e.device_type == DeviceType.CUDA and "gather_fwd" in e.name)
    seen = {r["linked"] for r in dev} | {r["corr"] for r in dev}
    host = [r for r in raw if r["device"] == "CPU"]
    host_end = max(r["end_ns"] for r in host)
    start = prof.profiler.kineto_results.trace_start_ns()
    lost = [dict(position=i, to_window_end_us=(host_end - r["end_ns"]) / 1e3,
                 from_window_start_us=(r["end_ns"] - start) / 1e3)
            for i, r in enumerate(launches) if r["corr"] not in seen]
    by_corr = {r["corr"]: r for r in dev}
    lag = [(by_corr[r["corr"]]["start_ns"] - r["end_ns"]) / 1e3 for r in launches
           if r["corr"] in by_corr]
    return dict(kineto=len(dev), function_events=fe, launches=len(launches), lost=lost,
                kernel_after_launch_us=(min(lag), max(lag)) if lag else None,
                trace_start_ns=start, raw=raw)


def burn(torch, seconds):
    """Profiled windows of many small launches, for ``seconds``."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1024, device="cuda")
    t0, windows, kernels = time.perf_counter(), 0, 0
    while time.perf_counter() - t0 < seconds:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4000):
                x.add_(1.0)
            torch.cuda.synchronize()
        prof.events()
        windows, kernels = windows + 1, kernels + 4000
    return windows, kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "tracer_records.json"))
    ap.add_argument("--burn", type=float, default=120.0)
    ap.add_argument("--idle", type=float, default=60.0)
    ap.add_argument("--pad_ms", type=float, default=25.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tracer_records: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from a_robust_registration_loss_tpu_torch.ops.cuda import _build
    from a_robust_registration_loss_tpu_torch.ops.cuda import gather as GK

    _build.library()
    B, N, C, Q = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.rand((B, N, C), generator=gen, device="cuda")
    idx = torch.randint(0, N, (B, Q), generator=gen, device="cuda")
    call = lambda: GK.gather_rows_fwd(table, idx)  # noqa: E731
    call()
    out, t_start = [], time.perf_counter()

    def record(stage, **kw):
        w = window(torch, call, **kw)
        w.update(stage=stage, process_s=round(time.perf_counter() - t_start, 1), **kw)
        out.append(w)
        lag = w["kernel_after_launch_us"]
        print(f"{stage:>14} t={w['process_s']:7.1f}s {kw}: kineto {w['kineto']}, "
              f"FunctionEvents {w['function_events']}, host launches {w['launches']}, lost "
              f"(position, us from the window's start) "
              f"{[(x['position'], round(x['from_window_start_us'], 1)) for x in w['lost']]}; "
              f"kernel start - launch end {lag and [round(x, 1) for x in lag]} us", flush=True)

    for _ in range(2):
        record("fresh")
    done = 0.0
    for step in (10.0, args.burn - 10.0)[:1 + (args.burn > 10)]:
        windows, kernels = burn(torch, step)
        done += step
        print(f"burn {step:.0f} s: {windows} profiled windows, {kernels} launches", flush=True)
        for _ in range(2):
            record(f"burn {done:.0f}s")
    for _ in range(2):
        time.sleep(args.idle)
        for _ in range(5):
            record(f"idle {args.idle:.0f}s")
            record("padded", pad_ms=args.pad_ms)
            record("primed", primed=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
