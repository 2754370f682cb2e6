"""The traced DCP epoch's share of the card's fp32 peak: the counted
matrix-product operations of its train steps (forward and backward) and
test pass (forward), and stage 1's and the resampler's counted operations
for their launches, over the window's seconds times 67 TFLOP/s."""

from portbench import trace as TR
from portbench.counts import peaks


def read(d):
    if not d.get("train_steps") or not d["ops"]:
        return None
    train, test = d["marks"]["train"][0], d["marks"]["eval"][0]
    n1 = len(TR.select(d, d["stage1_kernel"], between=(train, test)))
    n2 = len(TR.select(d, d["resample_kernel"], between=(train, test)))
    ops = (d["train_flops"] + d["eval_flops"] + n1 * d["stage1_ops"]
           + n2 * d["resample_ops"])
    return 100.0 * ops / (d["window_s"] * peaks.FP32_OPS)
