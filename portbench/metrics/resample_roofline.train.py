"""The resampler's share of its roofline in the DCP train steps: the
least time for the work its inputs need (``counts/kernels.py:resample``)
over its train-pass launches' device time."""

from portbench import trace as TR
from portbench.counts import peaks


def read(d):
    train, test = d["marks"].get("train"), d["marks"].get("eval")
    if not train or not test:
        return None
    ops = TR.select(d, d["resample_kernel"], between=(train[0], test[0]))
    if not ops:
        return None
    bound = len(ops) * peaks.bound_s(d["resample_ops"], d["resample_bytes"])
    return 100.0 * bound / TR.seconds(ops)
