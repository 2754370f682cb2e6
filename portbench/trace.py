"""The traced window of a ``--trace 1`` run and the digest its per-layer
metrics are read from.

``Window`` runs ``torch.profiler`` over the CPU and the card. It opens with
``PRIME`` spin kernels (``torch.cuda._sleep``): once the card has idled,
the tracer drops the first device records of a window, and the spins take
that loss; the window proper starts after them. ``digest`` reads the raw
Kineto events (no tree of Python objects, which a million kernels would
make slow): each device operation, the CUDA call that launched it (by
correlation id: the host's operators number their events apart, in ids
that can equal a launch's), the benchmark's own marks (``mark``), the
waits on the device, and the device's busy time as the union of its
operations' intervals inside the window.
"""

from __future__ import annotations

import torch

PRIME, PRIME_CYCLES = 64, 100_000
PRIME_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel, left out of every count
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
GRAPH_LAUNCH = "cudaGraphLaunch"
MARK = "portbench."            # prefix of the benchmark's own marks
TOP = 10                       # entries of each breakdown list


def mark(name: str):
    """A zero-length host mark ``portbench.<name>`` in the trace."""
    with torch.profiler.record_function(MARK + name):
        pass


class Window:
    """``with Window() as w: ...`` traces the block; ``w.digest()`` after."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        for _ in range(PRIME):
            torch.cuda._sleep(PRIME_CYCLES)
        torch.cuda.synchronize()
        mark("window_start")
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        mark("window_end")
        self.prof.__exit__(*exc)
        return False

    def digest(self):
        return digest(self.prof.profiler.kineto_results.events())


def _union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def digest(events):
    """The raw events -> a dict of plain numbers and lists (seconds):
    window_s, busy_s; ``ops`` a list of the device operations in the window
    as (name, start_ns, end_ns, host launch name, host launch start_ns);
    ``marks`` {name: [start_ns, ...]}; ``syncs`` [start_ns, ...] of the
    waits on the device; ``host`` [(name, start_ns, end_ns), ...] of the
    other host events; ``t0``/``t1`` the window's bounds in ns."""
    from torch.autograd import DeviceType

    marks, launches, host, device, syncs = {}, {}, [], [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if PRIME_KERNEL not in name:
                device.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.correlation_id()))
            continue
        start = e.start_ns()
        if name.startswith(MARK):
            marks.setdefault(name[len(MARK):], []).append(start)
            continue
        if name.startswith("cu"):  # a CUDA API call: its id is the device op's
            launches[e.correlation_id()] = (name, start)
        if name in SYNC_CALLS:
            syncs.append(start)
        host.append((name, start, start + e.duration_ns()))
    t0 = marks.get("window_start", [min((d[1] for d in device), default=0)])[0]
    t1 = marks.get("window_end", [max((d[2] for d in device), default=0)])[-1]
    ops = []
    for name, a, b, corr in device:
        if a >= t0 and a < t1:
            by, at = launches.get(corr, ("", a))
            ops.append((name, a, min(b, t1), by, at))
    busy = _union([(a, b) for _, a, b, _, _ in ops])
    return dict(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9, ops=ops, marks=marks,
                syncs=[s for s in syncs if t0 <= s < t1], host=host, t0=t0, t1=t1)


def complete(d) -> bool:
    """Whether the trace holds a record of every launch of the kernels the
    program counted in the window (``d["counted"]``: {name part: launches});
    a profiler whose buffer fills drops the rest."""
    return all(len(select(d, part)) == n for part, n in d.get("counted", {}).items())


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def select(d, name_part=None, launched_by=None, between=None):
    """The device operations of digest ``d`` whose name holds ``name_part``,
    launched by a host call named ``launched_by``, launched between the two
    ns times ``between``: a list of (name, start, end, by, at)."""
    out = []
    for op in d["ops"]:
        if name_part is not None and name_part not in op[0]:
            continue
        if launched_by is not None and op[3] != launched_by:
            continue
        if between is not None and not between[0] <= op[4] < between[1]:
            continue
        out.append(op)
    return out


def seconds(ops):
    return sum(b - a for _, a, b, _, _ in ops) / 1e9


def breakdown(d):
    """The device operations that took most time, and the longest idle gaps
    of the device labelled by the innermost host event around each gap's
    middle: {"device_ops": [[name, seconds], ...], "idle_gaps": [...]}."""
    by_name = {}
    for name, a, b, _, _ in d["ops"]:
        by_name[name] = by_name.get(name, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans = sorted((a, b) for _, a, b, _, _ in d["ops"])
    gaps, end = [], d["t0"]
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if d["t1"] > end:
        gaps.append((end, d["t1"]))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        around = [(e - s, name) for name, s, e in d["host"] if s <= mid < e]
        out.append([min(around)[1] if around else "host outside the profiler's events",
                    (b - a) / 1e9])
    return {"device_ops": [[n[:120], t / 1e9] for n, t in top], "idle_gaps": out}
