"""The card's idle time in the solves that read the host (DCP's SVD head,
eager between the captured pieces): device-idle ms inside the
``arrl.step.solve`` spans of the traced epoch's train pass
(``arrl.fit.train``), over its train steps."""

from portbench import spans as S


def read(d):
    train = S.spans(d, "arrl.fit.train")
    solves = S.inside(S.spans(d, "arrl.step.solve"), train)
    if not solves or not d.get("train_steps"):
        return None
    return S.idle_ns(solves, S.busy(d)) / 1e6 / d["train_steps"]
