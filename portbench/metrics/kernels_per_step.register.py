"""Kernels a replayed epoch of the classical step puts on the card: the
kernels launched by ``cudaGraphLaunch`` over the number of replays."""

from portbench import trace as TR


def read(d):
    launches = sum(1 for name, a, _ in d["host"] if name == TR.GRAPH_LAUNCH
                   and d["t0"] <= a < d["t1"])
    ops = [op for op in TR.select(d, launched_by=TR.GRAPH_LAUNCH) if TR.is_kernel(op[0])]
    if not launches or not ops:
        return None
    return len(ops) / launches
