"""Device ms of one replayed epoch of the classical step: the kernels that
the CUDA graph launches (their host launch is ``cudaGraphLaunch``), summed
over the traced registrations, over the number of replays."""

from portbench import trace as TR


def read(d):
    launches = sum(1 for name, a, _ in d["host"] if name == TR.GRAPH_LAUNCH
                   and d["t0"] <= a < d["t1"])
    ops = [op for op in TR.select(d, launched_by=TR.GRAPH_LAUNCH) if TR.is_kernel(op[0])]
    if not launches or not ops:
        return None
    return 1e3 * TR.seconds(ops) / launches
