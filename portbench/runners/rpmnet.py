"""The RPM-Net cell: a user fine-tuning RPM-Net with the robust loss on
partial scans through ``train/rpmnet.py:train`` (``Trainer.fit``, the
scanned epoch over a ``DeviceCache``, each step captured in pieces between
the Kabsch SVDs).

Set-up: the partial pairs of the traffic made from the seed, with their
normals (``partial.py``), their FPS + 3-NN neighbourhoods made on the card
by the reference's batched FPS, the weights drawn from the seed on the card
(``reference/rpmnet.py``), both handed to ``train`` (the weights as
``init_from``); the dataset goes to the card once, as the port's
``DeviceCache`` of a ``Loader``. The first epoch captures the graphs and is
set-up; the window is the epochs after it, each with its test pass and its
checkpoint write, until the first epoch boundary ``seconds`` after the
window opened. With ``trace``, the window is one epoch under the profiler.
This is the DCP cells' protocol (``runners/dcp.py``), whose helpers it
takes; what differs is RPM-Net's: the normals and the crop, the
checkpoint's ``ScheduledAdamState`` and the gather kernel among the
launches a traced run checks.

Afterwards the reference follows the first two epochs from the same
weights, batches and uniforms, and the program's checkpoint of each (its
parameters and Adam's first moment) and each epoch's loss are compared
with the reference's (``runners/dcp.py:gaps``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from portbench import partial as PT
from portbench import trace as TR
from portbench import traffic as TF
from portbench.counts import kernels as K
from portbench.counts import rpmnet as CR
from portbench.runners import common
from portbench.runners import dcp as D
from portbench.reference import core
from portbench.reference import rpmnet as RR

GATHER_KERNEL = "gather_fwd"  # the name part of the gather kernel's forward in a trace
SETTINGS = ("features", "feat_dim", "radius", "num_neighbors", "num_sk_iter", "add_slack",
            "num_train_reg_iter", "num_eval_reg_iter", "n_lines", "wt_inliers", "discount",
            "kmin", "kmax", "max_lr", "onecycle_epochs", "pct_start", "div_factor",
            "final_div_factor")


def model_settings(c: dict):
    return {k: c[k] for k in SETTINGS}


def make_items(spec, seed: int, count: int, stream: int, device):
    """``count`` partial pairs of the traffic in the plain form, their
    neighbourhoods (FPS seeds, each with its 3 nearest points) made on the
    card for all clouds at once."""
    items = [PT.rpm_item(*PT.partial_pair(spec, seed, i, stream)) for i in range(count)]
    clouds = torch.as_tensor(np.stack([np.stack([it["points_src_sample"],
                                                 it["points_tar_sample"]])
                                       for it in items]), device=device)
    n, _, N, _ = clouds.shape
    neis = core.neighbourhoods(clouds.reshape(2 * n, N, 3), spec["num_sample"])
    neis = neis.reshape(n, 2, -1, 3).cpu().numpy()
    for it, nb in zip(items, neis):
        it["points_based_neighs_src"], it["points_based_neighs_tar"] = nb[0], nb[1]
    return items


def program_config(c: dict, exp_dir: str, fit_seed: int):
    """``RPMTrainConfig`` at the configuration's settings."""
    from a_robust_registration_loss_tpu_torch.models.rpmnet import RPMNetConfig
    from a_robust_registration_loss_tpu_torch.train import harness as PH
    from a_robust_registration_loss_tpu_torch.train import losses as PL
    from a_robust_registration_loss_tpu_torch.train import rpmnet as PR

    return PR.RPMTrainConfig(
        max_lr=c["max_lr"], onecycle_epochs=c["onecycle_epochs"], pct_start=c["pct_start"],
        num_train_reg_iter=c["num_train_reg_iter"], num_eval_reg_iter=c["num_eval_reg_iter"],
        loss=PL.LossConfig(n_lines=c["n_lines"], kmin=c["kmin"], kmax=c["kmax"],
                           wt_inliers=c["wt_inliers"], discount=c["discount"]),
        model=RPMNetConfig(features=tuple(c["features"]), feat_dim=c["feat_dim"],
                           radius=c["radius"], num_neighbors=c["num_neighbors"],
                           num_sk_iter=c["num_sk_iter"], add_slack=c["add_slack"],
                           anneal=c["anneal"]),
        fit=PH.FitConfig(epochs=10**9, exp_dir=exp_dir, seed=fit_seed))


def launches():
    """The launch counters a traced run checks: stage 1's, the
    resampler's and the gather's forward."""
    from a_robust_registration_loss_tpu_torch.ops.cuda import gather as GA

    return dict(common.launches(), **{GATHER_KERNEL: GA.launches["fwd"]})


def run(cell, seed: int, seconds: float, trace: bool, t0: float):
    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.train import rpmnet as PR

    c, dev = cell.config, common.DEVICE
    m = model_settings(c)
    spec = dict(cell.traffic, num_sample=c["num_sample"])
    train_items = make_items(spec, seed, spec["train_pairs"], TF.STREAM_PAIR, dev)
    test_items = make_items(spec, seed, spec["test_pairs"], D.STREAM_TEST, dev)
    weights = RR.init_weights(m, seed, dev)
    common.free()  # the set-up's scratch memory is not the program's
    exp_dir = os.path.join(tempfile.gettempdir(), f"portbench_{cell.name}")
    shutil.rmtree(exp_dir, ignore_errors=True)
    fit_seed = seed % 2**63
    train_loader = DS.Loader(D.Items(train_items), spec["batch"], shuffle=True,
                             drop_last=True, seed=fit_seed)
    train_cache = DS.DeviceCache(train_loader, dev)
    test_cache = DS.DeviceCache(DS.Loader(D.Items(test_items), spec["test_batch"],
                                          shuffle=False, drop_last=False, seed=fit_seed), dev)
    st = dict(epochs=[], window=None, start=None)
    kept = os.path.join(exp_dir, "window_state.pt")

    def log(msg):
        if not msg.startswith("epoch "):
            return
        now = time.perf_counter()
        epoch = int(msg.split(":")[0].split()[1])
        if epoch == 0:
            st["setup_s"] = now - t0
            st["first"] = epoch_state(exp_dir, 0)
            common.reset_peak()
            if trace:
                st["before"] = launches()
                st["window"] = TR.Window().__enter__()
            st["start"] = time.perf_counter()
            return
        st["epochs"].append(now)
        if epoch == D.CHECKED and not os.path.exists(kept):
            # the window's first checkpoint is committed before this epoch's
            # save starts; a link keeps it past the trainer's rotation
            try:
                os.link(D.ckpt_file(exp_dir, D.CHECKED - 1), kept)
            except OSError:
                shutil.copyfile(D.ckpt_file(exp_dir, D.CHECKED - 1), kept)
        if trace:
            st["window"].__exit__(None, None, None)
            st["counted"] = {k: v - st["before"][k] for k, v in launches().items()}
            raise D._Stop
        if now - st["start"] >= seconds:
            raise D._Stop

    try:
        PR.train(program_config(c, exp_dir, fit_seed), train_cache, test_cache,
                 init_from=weights, log=log, device=dev)
    except D._Stop:
        pass
    for t in threading.enumerate():  # the last checkpoint's write
        if t is not threading.current_thread() and not t.daemon:
            t.join()
    memory = common.peak()
    window = epoch_state(exp_dir, D.CHECKED - 1,
                         kept if os.path.exists(kept) else D.ckpt_file(exp_dir, D.CHECKED - 1))
    wall = st["epochs"][-1] - st["start"]
    steps = len(train_cache) * len(st["epochs"])
    skipped = D.skipped_steps(exp_dir)
    e2e = {"train_pairs_per_s": steps * spec["batch"] / wall, "setup_s": st["setup_s"]}
    digest = None
    if trace:
        digest = st["window"].digest()
        digest["counted"] = st["counted"]
        counted(digest, spec, m, len(train_cache), train_items, seed, dev)
    del train_cache, test_cache
    common.free()

    t = time.perf_counter()
    values = check([st["first"], window], weights, train_items, train_loader, m, fit_seed,
                   dev)
    check_s = time.perf_counter() - t
    shutil.rmtree(exp_dir, ignore_errors=True)
    return dict(e2e=e2e, digest=digest, checks=common.checks(values, cell.limits),
                attempted=steps, failed=skipped, memory_peak_bytes=memory, check_s=check_s)


def epoch_state(exp_dir: str, epoch: int, path: str = None):
    """``runners/dcp.py:epoch_state`` of a checkpoint whose optimiser state
    is a ``ScheduledAdamState``, ((count, mu, nu), the schedule's count):
    Adam's first moment is its first part's."""
    state = D.epoch_state(exp_dir, epoch, path)
    path = D.ckpt_file(exp_dir, epoch) if path is None else path
    opt = torch.load(path, weights_only=True, map_location="cpu")["opt_state"]
    return dict(state, mu=opt[0][1])


def check(states, weights, train_items, loader, m, fit_seed: int, dev, loss_fn=RR.train_loss):
    """The program's epochs, one a state of ``states`` from the first,
    against the reference's (``compare``)."""
    data = {k: torch.as_tensor(np.stack([it[k] for it in train_items]), device=dev)
            for k in train_items[0]}
    rows = D.orders(loader.seed, loader.batch_size, len(train_items), len(states))
    ref = RR.follow(weights, data, rows, m, fit_seed, dev, loss_fn)
    names = RR.param_shapes(m)[0]
    got = [(st["loss"], torch.cat([st["params"][k].reshape(-1).to(dev) for k in names]),
            st["mu"].to(dev)) for st in states]
    return compare(ref, got, start_flat(weights, m), m)


def start_flat(weights, m):
    return torch.cat([weights[k].reshape(-1) for k in RR.param_shapes(m)[0]])


def compare(ref, got, start, m):
    """``runners/dcp.py:compare`` over RPM-Net's leaves: epoch by epoch,
    the numbers of ``gaps``, the window's first epoch's with its prefix."""
    values = {}
    for e, ((rl, rf, rm), (gl, gf, gm)) in enumerate(zip(ref, got)):
        g = D.gaps(rl, RR.leaf_norms(rm, m), RR.leaf_norms(rf - start, m),
                   gl, RR.leaf_norms(gm, m), RR.leaf_norms(gf - start, m))
        values.update({f"{D.PREFIX[e]}{k}": v for k, v in g.items()})
    return values


def hit_share(items, radius_scale: float, C: int, seed: int, dev) -> float:
    """The share of the resampler's candidates that pass the target's box,
    read by the reference off C fresh candidates of each pair's sphere."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2**63)
    hits = []
    for lo in range(0, len(items), 64):
        part = items[lo:lo + 64]
        tar = torch.as_tensor(np.stack([it["points_tar_sample"] for it in part]), device=dev)
        box = torch.as_tensor(np.stack([it["tar_box"] for it in part]), device=dev)
        r = radius_scale * torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
        ctr = torch.as_tensor(np.stack([it["centers"] for it in part]), device=dev)
        cand = core.candidates(torch.rand((len(part), 4, C), generator=gen, device=dev), r, ctr)
        hits.append(core.mesh_hit(core.box_faces(tar), cand).float().mean(-1))
    return float(torch.cat(hits).mean())


def counted(d, spec, m, steps: int, train_items, seed: int, dev):
    """The counted work beside the trace: the train and test passes' model
    FLOPs (``counts/rpmnet.py``), and per launch stage 1's, the
    resampler's (its target-box hits at the whole diagonal) and the
    gather's operations and bytes at the train pass's batched shapes."""
    B, L = spec["batch"], m["n_lines"]
    N = train_items[0]["points_src_sample"].shape[0]
    F = train_items[0]["points_based_neighs_src"].shape[0] // 3
    full, rem = divmod(spec["test_pairs"], spec["test_batch"])
    n_eval = m["num_eval_reg_iter"]
    d["train_steps"] = steps
    d["train_flops"] = steps * CR.train_step(m, B, N, F)
    d["eval_flops"] = (full * CR.forward(m, spec["test_batch"], N, n_eval)
                       + (CR.forward(m, rem, N, n_eval) if rem else 0))
    d["stage1_ops"], d["stage1_bytes"] = K.stage1(B, L, F, F, m["kmax"])
    C = core.ROUNDS * L
    share = hit_share(train_items, 1.0, C, seed, dev)
    d["resample_ops"], d["resample_bytes"] = K.resample(B, C, B * C * share)
    d["gather_bytes"] = CR.gather_bytes(B, N, m["num_neighbors"])
    d["stage1_kernel"], d["resample_kernel"], d["gather_kernel"] = (
        "stage1_kernel", "resample_kernel", GATHER_KERNEL)
