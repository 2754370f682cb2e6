"""``Trainer.fit``'s eval pass in the traced epoch: the length of its
``arrl.fit.eval`` span (the test steps and their fetch), ms on the host."""

from portbench import spans as S


def read(d):
    passes = S.spans(d, "arrl.fit.eval")
    return S.ms(passes) / len(passes) if passes else None
