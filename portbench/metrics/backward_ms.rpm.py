"""Device ms of one RPM-Net train step's backward: the kernels launched
inside the ``arrl.step.backward`` spans of the traced epoch's train pass
(``arrl.fit.train``), over its train steps."""

from portbench import launched as LA
from portbench import spans as S
from portbench import trace as TR


def read(d):
    parts = S.inside(S.spans(d, "arrl.step.backward"), S.spans(d, "arrl.fit.train"))
    ops = LA.kernels(d, parts)
    if not ops or not d.get("train_steps"):
        return None
    return 1e3 * TR.seconds(ops) / d["train_steps"]
