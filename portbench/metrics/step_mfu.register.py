"""The classical step's share of the card's fp32 peak: stage 1's and the
resampler's counted operations for their launches in the traced window,
over the window's seconds times 67 TFLOP/s. The glue is not counted."""

from portbench import trace as TR
from portbench.counts import peaks


def read(d):
    n1 = len(TR.select(d, d["stage1_kernel"]))
    n2 = len(TR.select(d, d["resample_kernel"]))
    if not n1 and not n2:
        return None
    ops = n1 * d["stage1_ops"] + n2 * d["resample_ops"]
    return 100.0 * ops / (d["window_s"] * peaks.FP32_OPS)
