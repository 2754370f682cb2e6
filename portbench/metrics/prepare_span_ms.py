"""``prepare_pair`` (FPS + 3-NN of both clouds, centring, the sphere) as
the requests of the window ran it: the mean length of their
``arrl.classical.prepare`` spans, ms on the host, ending when the host
returns (no synchronise; the profiler slows its FPS loop)."""

from portbench import spans as S


def read(d):
    prepares = S.spans(d, "arrl.classical.prepare")
    return S.ms(prepares) / len(prepares) if prepares else None
