"""The control of the RPM-Net cell's comparison and the faults it must
catch: readings that set each limit's upper end (``control.py`` for the
other cells). The benchmark's own runs never run this.

The control is the plain reference put in the program's place and
computed with TF32 operands in every matrix product (``reference/core.py``
``CONTROL``), one step below the configuration's fp32. The faults, each
planted in the reference put in the program's place: half of the batch
left out; the loss 1% off; the Sinkhorn slack row and column dropped; one
Sinkhorn iteration fewer; the transform not detached between the
registration iterations. Each is compared with the fp32 reference exactly
as a run compares the program, at the cell's own sizes and inputs, over
the epochs a run checks:

    python3 -m portbench.control_rpmnet --workload rpmnet.train_b8 --seeds <n> [<n> ...]

prints one JSON line a seed and reading: its numbers beside the limits.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import control, spec
from portbench import traffic as TF
from portbench.runners import common
from portbench.runners import dcp as D
from portbench.runners import rpmnet as RN
from portbench.reference import core
from portbench.reference import rpmnet as RR


def half_batch(P, batch, u4, m):
    """Half of the batch left out, the loss taken over the rest."""
    h = u4.shape[0] // 2
    return RR.train_loss(P, {k: v[:h] for k, v in batch.items()}, u4[:h], m)


def altered(P, batch, u4, m):
    """The answer altered where it is produced, the loss 1% off."""
    return RR.train_loss(P, batch, u4, m) * (1 + control.ALTERED)


def no_slack(P, batch, u4, m):
    """Sinkhorn without its slack row and column."""
    return RR.train_loss(P, batch, u4, dict(m, add_slack=False))


def fewer_sinkhorn(P, batch, u4, m):
    """One Sinkhorn iteration fewer."""
    return RR.train_loss(P, batch, u4, dict(m, num_sk_iter=m["num_sk_iter"] - 1))


def attached(P, batch, u4, m):
    """The transform not detached between the registration iterations."""
    return RR.train_loss(P, batch, u4, m, detach=False)


FAULTS = (half_batch, altered, no_slack, fewer_sinkhorn, attached)


def readings(cell, seed: int, faults=FAULTS):
    """The control, and the reference with each of ``faults`` planted, in
    the program's place, against the reference over the epochs a run
    checks, from the run's weights and pairs: {reading: numbers}."""
    c, dev = cell.config, common.DEVICE
    m = RN.model_settings(c)
    spec_ = dict(cell.traffic, num_sample=c["num_sample"])
    items = RN.make_items(spec_, seed, spec_["train_pairs"], TF.STREAM_PAIR, dev)
    weights = RR.init_weights(m, seed, dev)
    data = {k: torch.as_tensor(np.stack([it[k] for it in items]), device=dev) for k in items[0]}
    fit_seed = seed % 2**63
    rows = D.orders(fit_seed, spec_["batch"], len(items), D.CHECKED)
    start = RN.start_flat(weights, m)

    def epochs(loss_fn=RR.train_loss):
        return RR.follow(weights, data, rows, m, fit_seed, dev, loss_fn)

    ref = epochs()
    core.CONTROL["tf32"] = True
    try:
        got = {"control": epochs()}
    finally:
        core.CONTROL["tf32"] = False
    for f in faults:
        got[f.__name__] = epochs(f)
    return {name: RN.compare(ref, g, start, m) for name, g in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", default="rpmnet.train_b8")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload, spec.load_benchmark())
    for seed in args.seeds:
        for name, values in readings(cell, seed).items():
            checks = common.checks(values, cell.limits)
            print(json.dumps({"workload": cell.name, "seed": seed, "reading": name,
                              "numbers": checks,
                              "fails": any(c["value"] > c["limit"] for c in checks.values())}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
