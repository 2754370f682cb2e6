"""Device ms of one RPM-Net train step: the kernels launched inside the
traced epoch's train pass (``arrl.fit.train``: the graph replays of the
pieces, the eager SVDs, the backward and the update), over its train
steps."""

from portbench import launched as LA
from portbench import spans as S
from portbench import trace as TR


def read(d):
    ops = LA.kernels(d, S.spans(d, "arrl.fit.train"))
    if not ops or not d.get("train_steps"):
        return None
    return 1e3 * TR.seconds(ops) / d["train_steps"]
