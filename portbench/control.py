"""The control of the comparison that decides ``correct``, and the faults
it must catch: readings that set each limit's upper end. The benchmark's
own runs never run this.

The control is the plain reference put in the program's place and
computed one step below the precision the configurations state (fp32 with
TF32 off): every matrix product with TF32 operands (``reference/core.py``
``CONTROL``). Its outputs are compared with the fp32 reference's exactly as
a run compares the program's, at the cell's own sizes and inputs:

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed: the control's numbers beside the limits;
with ``--faults``, for a training cell, also those of each fault planted
in the reference put in the program's place (half of the batch left out;
the loss altered where it is produced). A state left unchanged reads 1 by
the parameters' change and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import spec
from portbench import traffic as TF
from portbench.runners import common
from portbench.reference import classical as RC
from portbench.reference import core
from portbench.reference import dcp as RD


def _both(fn):
    """fn() in fp32 and under the control's TF32 products."""
    core.CONTROL["tf32"] = False
    ref = fn()
    core.CONTROL["tf32"] = True
    try:
        low = fn()
    finally:
        core.CONTROL["tf32"] = False
    return ref, low


def classical(cell, seed: int):
    """The control against the reference on requests of this seed's
    traffic, as many as a run checks, followed through all their epochs."""
    from portbench.runners import classical as D

    s = D.settings(cell)
    values = {"loss_gap": 0.0, "chamfer_gap": 0.0, "twist_gap": 0.0, "unfinished": 0.0}
    for i in common.sample(seed, cell.traffic["check_requests"] * 4,
                           cell.traffic["check_requests"]):
        a, b, _, _ = TF.pair(cell.traffic, seed, i)
        ref, low = _both(lambda: RC.follow(a, b, s, s["epochs"], common.DEVICE))
        D.gap(values, low, ref)
    return values


ALTERED = 1e-2  # the altered answer's loss is this share off


def half_batch(P, batch, u4, m):
    """A fault: half of the batch left out, the mean taken over the rest."""
    h = u4.shape[0] // 2
    return RD.train_loss(P, {k: v[:h] for k, v in batch.items()}, u4[:h], m)


def altered(P, batch, u4, m):
    """A fault: the answer altered where it is produced, the loss 1% off."""
    return RD.train_loss(P, batch, u4, m) * (1 + ALTERED)


def dcp(cell, seed: int, faults=()):
    """The control, and the reference with each of ``faults`` planted, in
    the program's place, against the reference over the epochs a run
    checks, from the run's weights and pairs: {reading: numbers}."""
    from portbench.runners import dcp as D

    c, dev = cell.config, common.DEVICE
    m = D.model_settings(c)
    spec_ = dict(cell.traffic, num_sample=c["num_sample"])
    items = D.make_items(spec_, seed, spec_["train_pairs"], TF.STREAM_PAIR, dev)
    weights = RD.init_weights(m, seed, dev)
    data = {k: torch.as_tensor(np.stack([it[k] for it in items]), device=dev) for k in items[0]}
    fit_seed = seed % 2**63
    rows = D.orders(fit_seed, spec_["batch"], len(items), D.CHECKED)
    start = D.start_flat(weights, m)

    def epochs(loss_fn=RD.train_loss):
        return RD.follow(weights, data, rows, m, fit_seed, dev, loss_fn)

    ref = epochs()
    core.CONTROL["tf32"] = True
    try:
        readings = {"control": epochs()}
    finally:
        core.CONTROL["tf32"] = False
    for f in faults:
        readings[f.__name__] = epochs(f)
    return {name: D.compare(ref, got, start, m) for name, got in readings.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true",
                    help="also the training faults planted in the reference: half the "
                         "batch left out, the loss altered")
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload, spec.load_benchmark())
    for seed in args.seeds:
        if cell.config["runner"] == "dcp":
            readings = dcp(cell, seed, (half_batch, altered) if args.faults else ())
        else:
            readings = {"control": classical(cell, seed)}
        for name, values in readings.items():
            checks = common.checks(values, cell.limits)
            print(json.dumps({"workload": cell.name, "seed": seed, "reading": name,
                              "numbers": checks,
                              "fails": any(c["value"] > c["limit"] for c in checks.values())}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
