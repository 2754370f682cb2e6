"""The share of the traced window in which no operation ran on the card:
whole registrations in the classical cells (in ``refine`` mostly
``prepare_pair``'s FPS loop, which the host drives one small launch at a
time), a whole epoch with its test pass and checkpoint in the DCP cells."""


def read(d):
    if d["window_s"] <= 0 or not d["ops"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
