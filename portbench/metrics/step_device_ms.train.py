"""Device ms of one DCP train step: the kernels launched between the
train pass's mark and the test pass's mark of the traced epoch (graph
replays and the eager solves alike), over the epoch's train steps."""

from portbench import trace as TR


def read(d):
    train, test = d["marks"].get("train"), d["marks"].get("eval")
    if not train or not test or not d.get("train_steps"):
        return None
    ops = [op for op in TR.select(d, between=(train[0], test[0])) if TR.is_kernel(op[0])]
    if not ops:
        return None
    return 1e3 * TR.seconds(ops) / d["train_steps"]
