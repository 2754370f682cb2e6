"""The gather kernel's share of its roofline in the RPM-Net train steps
(the neighbours' xyz and normals of a feature pass, ``csrc/gather.cu``):
the least time of its launches in the train pass (``arrl.fit.train``), its
bytes (``counts/rpmnet.py:gather_bytes``) over 3.35 TB/s, over their
device time."""

from portbench import launched as LA
from portbench import spans as S
from portbench import trace as TR
from portbench.counts import peaks


def read(d):
    ops = [op for op in LA.kernels(d, S.spans(d, "arrl.fit.train"))
           if d["gather_kernel"] in op[0]]
    if not ops:
        return None
    return 100.0 * len(ops) * peaks.bound_s(0, d["gather_bytes"]) / TR.seconds(ops)
