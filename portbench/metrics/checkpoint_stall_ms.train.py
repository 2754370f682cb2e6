"""The checkpoint on ``Trainer.fit``'s loop thread in the traced epoch: the
length of its ``arrl.fit.checkpoint`` span (the wait for the previous
epoch's commit, then the state's device-to-host copy), ms on the host; the
commit's own thread is not spanned."""

from portbench import spans as S


def read(d):
    saves = S.spans(d, "arrl.fit.checkpoint")
    return S.ms(saves) / len(saves) if saves else None
