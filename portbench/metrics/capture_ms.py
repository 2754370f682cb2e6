"""The per-request build of the classical step's CUDA graph (the first
epoch's eager step and the capture): ``arrl.classical.capture`` ms over the
window's requests (``arrl.classical.run`` spans)."""

from portbench import spans as S


def read(d):
    runs = S.spans(d, "arrl.classical.run")
    captures = S.inside(S.spans(d, "arrl.classical.capture"), runs)
    return S.ms(captures) / len(runs) if runs and captures else None
