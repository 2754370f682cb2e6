"""The card's idle time that no part of the program accounts for: the
share (%) of the window's device-idle time outside every program span but
the roots (a request's ``arrl.classical.run``, an epoch's
``arrl.fit.epoch``)."""

from portbench import spans as S


def read(d):
    parts = S.spans(d, but=S.ROOTS)
    if not parts or not d["ops"]:
        return None
    busy = S.busy(d)
    idle = S.idle_ns([(d["t0"], d["t1"])], busy)
    if idle <= 0:
        return None
    return 100.0 * (idle - S.idle_ns(parts, busy)) / idle
