"""The device operations of a traced window's digest launched inside the
program's spans: an operation falls in a span by the host time of the call
that launched it (a graph's kernels by their ``cudaGraphLaunch``)."""

from __future__ import annotations

import bisect

from portbench import trace as TR


def kernels(d, intervals):
    """The kernels (no copies or fills) launched inside one of the
    (start_ns, end_ns) ``intervals``, as ``trace.select`` gives them."""
    ops = sorted((op for op in d["ops"] if TR.is_kernel(op[0])), key=lambda op: op[4])
    at = [op[4] for op in ops]
    out = []
    for a, b in intervals:
        out += ops[bisect.bisect_left(at, a):bisect.bisect_left(at, b)]
    return out
