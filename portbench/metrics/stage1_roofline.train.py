"""Stage 1's share of its roofline in the DCP train steps (the batched
shapes): the least time of its launches in the train pass (counted
operations over 67 TFLOP/s or bytes over 3.35 TB/s, the larger) over
their device time."""

from portbench import trace as TR
from portbench.counts import peaks


def read(d):
    train, test = d["marks"].get("train"), d["marks"].get("eval")
    if not train or not test:
        return None
    ops = TR.select(d, d["stage1_kernel"], between=(train[0], test[0]))
    if not ops:
        return None
    bound = len(ops) * peaks.bound_s(d["stage1_ops"], d["stage1_bytes"])
    return 100.0 * bound / TR.seconds(ops)
