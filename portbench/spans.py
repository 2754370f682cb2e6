"""The program's own spans in a traced window's digest: the port's
profiler ranges (``utils/timing.py:SPANS``, every name ``arrl.``), which
``trace.digest`` keeps among the host events, on the clock of the device's
operations.

A span is read only where it opens and closes inside the window: the DCP
window opens and closes inside ``train``'s log callback, so it cuts the
epochs' roots, and a range still open when the profiler stops ends there,
after the window's end mark.
"""

from __future__ import annotations

import bisect

PREFIX = "arrl."
ROOTS = ("arrl.classical.run", "arrl.fit.epoch")  # a request's, an epoch's


def spans(d, name=None, but=()):
    """(start_ns, end_ns) of the window's spans named ``name``, or where
    None of every program span not named in ``but``, by start."""
    return sorted((a, b) for n, a, b in d["host"]
                  if (n == name if name is not None else n.startswith(PREFIX) and n not in but)
                  and d["t0"] <= a and b <= d["t1"])


def inside(intervals, outer):
    """The intervals that lie inside one of ``outer``."""
    return [(a, b) for a, b in intervals if any(x <= a and b <= y for x, y in outer)]


def ms(intervals):
    return sum(b - a for a, b in intervals) / 1e6


def merged(intervals):
    """The union of (start, end) intervals as disjoint ones, by start."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(d):
    """The window's device-busy time as disjoint intervals, by start."""
    return merged((a, b) for _, a, b, _, _ in d["ops"])


def idle_ns(intervals, busy_list):
    """Device-idle ns inside the union of ``intervals``: their length less
    what the disjoint ``busy_list`` covers of it."""
    starts = [a for a, _ in busy_list]
    total = 0
    for a, b in merged(intervals):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        covered = 0
        while i < len(busy_list) and busy_list[i][0] < b:
            x, y = busy_list[i]
            covered += max(0, min(y, b) - max(x, a))
            i += 1
        total += (b - a) - covered
    return total
