"""The traced RPM-Net epoch's share of the card's fp32 peak: the counted
matrix-product operations of its train steps (forward and backward) and
test pass (forward), and stage 1's and the resampler's counted operations
for their launches in the train pass (``arrl.fit.train``), over the
window's seconds times 67 TFLOP/s."""

from portbench import launched as LA
from portbench import spans as S
from portbench.counts import peaks


def read(d):
    ops = LA.kernels(d, S.spans(d, "arrl.fit.train"))
    if not ops or not d.get("train_steps"):
        return None
    n1 = sum(1 for op in ops if d["stage1_kernel"] in op[0])
    n2 = sum(1 for op in ops if d["resample_kernel"] in op[0])
    work = (d["train_flops"] + d["eval_flops"] + n1 * d["stage1_ops"]
            + n2 * d["resample_ops"])
    return 100.0 * work / (d["window_s"] * peaks.FP32_OPS)
