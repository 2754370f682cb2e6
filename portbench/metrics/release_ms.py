"""The end of a request: the classical step's graph and its private memory
pool freed (``_loop``'s ``state.clear()``), ``arrl.classical.release`` ms
over the window's requests (``arrl.classical.run`` spans)."""

from portbench import spans as S


def read(d):
    runs = S.spans(d, "arrl.classical.run")
    releases = S.inside(S.spans(d, "arrl.classical.release"), runs)
    return S.ms(releases) / len(runs) if runs and releases else None
