"""Stage 1's share of its roofline in the classical cells: the least time
its launches could take (counted operations over 67 TFLOP/s, or bytes
over 3.35 TB/s, the larger) over their device time."""

from portbench import trace as TR
from portbench.counts import peaks


def read(d):
    ops = TR.select(d, d["stage1_kernel"])
    if not ops:
        return None
    bound = len(ops) * peaks.bound_s(d["stage1_ops"], d["stage1_bytes"])
    return 100.0 * bound / TR.seconds(ops)
