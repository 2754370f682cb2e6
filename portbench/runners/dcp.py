"""The DCP cells: a user fine-tuning DCP-v2 with the robust loss through
``train/dcp.py:train`` (``Trainer.fit``, the scanned epoch over a
``DeviceCache``, each step captured in pieces between the SVD solves).

Set-up: the pairs of the traffic made from the seed, their FPS + 3-NN
neighbourhoods made on the card by the reference's batched FPS, the
weights drawn from the seed on the card (``reference/dcp.py``), both
handed to ``train`` (the weights as ``init_from``); the dataset goes to the
card once, as the port's ``DeviceCache`` of a ``Loader``. The first epoch
captures the graphs and is set-up; it is also the epoch the reference
checks. The window: the epochs after it, each with its test pass and its
checkpoint write, until the first epoch boundary ``seconds`` after the
window opened (``train``'s ``log`` callback marks the boundaries; the fit
is ended there). With ``trace``, the window is one epoch under the
profiler.

Afterwards the reference follows the first two epochs from the same
weights, batches and uniforms: the set-up's epoch, and the window's first,
which runs the reshuffled index plan through the captured graphs after the
test pass. The program's checkpoint of each (its parameters and Adam's
first moment) and each epoch's loss are compared with the reference's.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from portbench import trace as TR
from portbench import traffic as TF
from portbench.counts import dcp as CD
from portbench.counts import kernels as K
from portbench.runners import common
from portbench.reference import core
from portbench.reference import dcp as RD

STREAM_TEST = 4       # the seed's stream of the test pairs (the train pairs: STREAM_PAIR)
CKPT_WAIT_S = 300.0   # how long the set-up waits for the first checkpoint's file
CHECKED = 2           # epochs the reference follows: the set-up's and the window's first
ZERO_GRAD = 1e-3      # a leaf whose reference moment is under this share of the median's


class _Stop(Exception):
    """Raised from ``train``'s log callback at an epoch boundary to end the fit."""


class Items:
    """The pairs of a split as the dataset contract's dicts (a dataset a
    ``Loader`` takes)."""

    corrupt = None

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def make_items(spec, seed: int, count: int, stream: int, device):
    """``count`` pairs of the traffic in the DCP form, their neighbourhoods
    (FPS seeds, each with its 3 nearest points) made on the card for all
    clouds at once."""
    items = [TF.dcp_item(*TF.pair(spec, seed, i, stream)) for i in range(count)]
    clouds = torch.as_tensor(np.stack([np.stack([it["points_src_sample"],
                                                 it["points_tar_sample"]])
                                       for it in items]), device=device)
    n, _, N, _ = clouds.shape
    neis = core.neighbourhoods(clouds.reshape(2 * n, N, 3), spec.get("num_sample", N))
    neis = neis.reshape(n, 2, -1, 3).cpu().numpy()
    for it, nb in zip(items, neis):
        it["points_based_neighs_src"], it["points_based_neighs_tar"] = nb[0], nb[1]
    return items


def model_settings(c: dict):
    return {k: c[k] for k in ("emb_dims", "n_blocks", "n_heads", "ff_dims", "dgcnn_k",
                              "n_lines", "kmin", "kmax", "lr")}


def run(cell, seed: int, seconds: float, trace: bool, t0: float):
    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.models.dcp import DCPConfig
    from a_robust_registration_loss_tpu_torch.train import dcp as PD
    from a_robust_registration_loss_tpu_torch.train import harness as PH
    from a_robust_registration_loss_tpu_torch.train import losses as PL

    class Marked(DS.DeviceCache):
        """The port's ``DeviceCache``; each epoch's plan, asked for when a
        train or test pass starts, leaves a mark in the trace."""

        def __init__(self, loader, device, phase):
            super().__init__(loader, device)
            self.phase = phase

        def next_epoch(self):
            TR.mark(self.phase)
            return super().next_epoch()

    c, spec, dev = cell.config, cell.traffic, common.DEVICE
    m = model_settings(c)
    spec = dict(spec, num_sample=c["num_sample"])
    train_items = make_items(spec, seed, spec["train_pairs"], TF.STREAM_PAIR, dev)
    test_items = make_items(spec, seed, spec["test_pairs"], STREAM_TEST, dev)
    weights = RD.init_weights(m, seed, dev)
    common.free()  # the set-up's scratch memory is not the program's
    exp_dir = os.path.join(tempfile.gettempdir(), f"portbench_{cell.name}")
    shutil.rmtree(exp_dir, ignore_errors=True)
    fit_seed = seed % 2**63
    cfg = PD.DCPTrainConfig(
        lr=c["lr"], loss=PL.LossConfig(n_lines=c["n_lines"], kmin=c["kmin"], kmax=c["kmax"]),
        model=DCPConfig(emb_nn=c["emb_nn"], pointer=c["pointer"], head=c["head"],
                        emb_dims=c["emb_dims"], n_blocks=c["n_blocks"], n_heads=c["n_heads"],
                        ff_dims=c["ff_dims"], dgcnn_k=c["dgcnn_k"], cycle=c["cycle"]),
        fit=PH.FitConfig(epochs=10**9, exp_dir=exp_dir, seed=fit_seed))
    train_loader = DS.Loader(Items(train_items), spec["batch"], shuffle=True, drop_last=True,
                             seed=fit_seed)
    train_cache = Marked(train_loader, dev, "train")
    test_cache = Marked(DS.Loader(Items(test_items), spec["test_batch"], shuffle=False,
                                  drop_last=False, seed=fit_seed), dev, "eval")
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
                st["before"] = common.launches()
                st["window"] = TR.Window().__enter__()
            st["start"] = time.perf_counter()
            return
        st["epochs"].append(now)
        if epoch == CHECKED and not os.path.exists(kept):
            # the window's first checkpoint is committed before this epoch's
            # save starts; a link keeps it past the trainer's rotation
            try:
                os.link(ckpt_file(exp_dir, CHECKED - 1), kept)
            except OSError:
                shutil.copyfile(ckpt_file(exp_dir, CHECKED - 1), kept)
        if trace:
            st["window"].__exit__(None, None, None)
            st["counted"] = {k: v - st["before"][k] for k, v in common.launches().items()}
            raise _Stop
        if now - st["start"] >= seconds:
            raise _Stop

    try:
        PD.train(cfg, train_cache, test_cache, init_from=weights, log=log, device=dev)
    except _Stop:
        pass
    for t in threading.enumerate():  # the last checkpoint's write
        if t is not threading.current_thread() and not t.daemon:
            t.join()
    memory = common.peak()
    window = epoch_state(exp_dir, CHECKED - 1,
                         kept if os.path.exists(kept) else ckpt_file(exp_dir, CHECKED - 1))
    n_epochs = len(st["epochs"])
    wall = st["epochs"][-1] - st["start"]
    steps = len(train_cache) * n_epochs
    skipped = skipped_steps(exp_dir)
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


def ckpt_file(exp_dir: str, epoch: int) -> str:
    return os.path.join(exp_dir, "checkpoints", f"ckpt-{epoch}", "state.pt")


def epoch_state(exp_dir: str, epoch: int, path: str = None):
    """The program's state after ``epoch``: its checkpoint (the parameters
    and Adam's state), read as soon as its file is written, from ``path``
    where given, and the epoch's train loss from the metrics log."""
    path = ckpt_file(exp_dir, epoch) if path is None else path
    waited = 0.0
    while not os.path.exists(path):
        if waited > CKPT_WAIT_S:
            raise RuntimeError(f"no checkpoint at {path} after {CKPT_WAIT_S} s")
        time.sleep(0.01)
        waited += 0.01
    state = torch.load(path, weights_only=True, map_location="cpu")
    loss = None
    with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == "train/loss" and rec["step"] == epoch:
                loss = rec["value"]
    return dict(params=state["params"], mu=state["opt_state"][1], loss=loss)


def skipped_steps(exp_dir: str) -> int:
    """Steps the guard skipped on a non-finite loss or gradient, all epochs."""
    n = 0
    with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == "train/nonfinite_steps":
                n += int(rec["value"])
    return n


def check(states, weights, train_items, loader, m, fit_seed: int, dev):
    """The program's epochs, one a state of ``states`` from the first,
    against the reference's (``compare``)."""
    keys = train_items[0].keys()
    data = {k: torch.as_tensor(np.stack([it[k] for it in train_items]), device=dev)
            for k in keys}
    rows = orders(loader.seed, loader.batch_size, len(train_items), len(states))
    ref = RD.follow(weights, data, rows, m, fit_seed, dev)
    names = RD.param_shapes(m)[0]
    got = [(st["loss"], torch.cat([st["params"][k].reshape(-1).to(dev) for k in names]),
            st["mu"].to(dev)) for st in states]
    return compare(ref, got, start_flat(weights, m), m)


PREFIX = ("", "window_")  # the names of the set-up's epoch and of the window's first


def orders(seed: int, batch: int, n: int, epochs: int):
    """The batches' rows of the first ``epochs`` epochs, (epochs, n_batches,
    batch): the permutation of (the loader's seed, epoch), its whole
    batches."""
    return np.stack([np.random.default_rng((seed, e)).permutation(n)[:n // batch * batch]
                     .reshape(-1, batch) for e in range(epochs)])


def start_flat(weights, m):
    return torch.cat([weights[k].reshape(-1) for k in RD.param_shapes(m)[0]])


def compare(ref, got, start, m):
    """The numbers compared, epoch by epoch, of ``got`` against ``ref``
    (each per epoch: the mean loss, the flat parameters, the flat first
    moment) from the flat parameters ``start`` (``gaps``); the numbers of
    an epoch after the first carry its prefix, ``window_`` for the
    window's first."""
    values = {}
    for e, ((rl, rf, rm), (gl, gf, gm)) in enumerate(zip(ref, got)):
        g = gaps(rl, RD.leaf_norms(rm, m), RD.leaf_norms(rf - start, m),
                 gl, RD.leaf_norms(gm, m), RD.leaf_norms(gf - start, m))
        values.update({f"{PREFIX[e]}{k}": v for k, v in g.items()})
    return values


def gaps(ref_loss, ref_mu, ref_step, loss, mu, step):
    """The numbers compared: the epoch's mean loss; per parameter, the norm
    of Adam's first moment (the epoch's gradients) and the norm of the
    parameters' change, each gap against the larger of the reference's
    norm of that leaf and of the median leaf's, the worst leaf. Leaves
    whose reference moment is nought to rounding (under ZERO_GRAD of the
    median leaf's, as a key's bias under softmax) move by round-off alone
    and are left out of the change."""
    med_mu = float(np.median(list(ref_mu.values())))
    med_step = float(np.median(list(ref_step.values())))
    moved = [k for k in ref_mu if ref_mu[k] >= ZERO_GRAD * med_mu]
    return {"loss_gap": common.rel_gap(loss, ref_loss),
            "moment_gap": max(abs(mu[k] - ref_mu[k]) / max(ref_mu[k], med_mu)
                              for k in ref_mu),
            "step_gap": max(abs(step[k] - ref_step[k]) / max(ref_step[k], med_step)
                            for k in moved)}


def counted(d, spec, m, steps: int, train_items, seed: int, dev):
    """The counted work beside the trace: the train and test passes' model
    FLOPs, and per launch stage 1's and the resampler's operations and
    bytes at the train pass's batched shapes, the target-box hits of the
    resampler read off fresh candidates of each training pair's sphere by
    the reference."""
    B, N, L = spec["batch"], spec["points"], m["n_lines"]
    F = train_items[0]["points_based_neighs_src"].shape[0] // 3
    d["train_steps"] = steps
    d["train_flops"] = steps * CD.train_step(m, B, N)
    d["eval_flops"] = spec["test_pairs"] * CD.forward(m, spec["test_batch"], N)
    d["stage1_ops"], d["stage1_bytes"] = K.stage1(B, L, F, F, m["kmax"])
    C = core.ROUNDS * L
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2**63)
    hits = []
    for lo in range(0, len(train_items), 64):
        part = train_items[lo:lo + 64]
        tar = torch.as_tensor(np.stack([it["points_tar_sample"] for it in part]), device=dev)
        box = torch.as_tensor(np.stack([it["tar_box"] for it in part]), device=dev)
        r = 0.5 * torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
        ctr = torch.as_tensor(np.stack([it["centers"] for it in part]), device=dev)
        u4 = torch.rand((len(part), 4, C), generator=gen, device=dev)
        cand = core.candidates(u4, r, ctr)
        hits.append(core.mesh_hit(core.box_faces(tar), cand).float().mean(-1))
    share = float(torch.cat(hits).mean())
    d["resample_ops"], d["resample_bytes"] = K.resample(B, C, B * C * share)
    d["stage1_kernel"], d["resample_kernel"] = "stage1_kernel", "resample_kernel"
