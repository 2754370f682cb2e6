"""The resampler's share of its roofline in the classical cells: the least
time for the work its inputs need (``counts/kernels.py:resample``) over
its launches' device time."""

from portbench import trace as TR
from portbench.counts import peaks


def read(d):
    ops = TR.select(d, d["resample_kernel"])
    if not ops:
        return None
    bound = len(ops) * peaks.bound_s(d["resample_ops"], d["resample_bytes"])
    return 100.0 * bound / TR.seconds(ops)
