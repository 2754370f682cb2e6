"""The classical cells: one client registering pairs of scans, one after
another, each by a whole ``train/classical.py:run`` call, as
``register.py`` runs it: host clouds in, the twist and the history out.

A run: set-up (imports, the card, the kernel library, one warm-up
registration at the cell's sizes, shorter), then the window: request i is
pair i of the traffic, started while fewer than ``seconds`` have passed
since the window opened; the window closes when the last one started has
ended. With ``trace`` the window instead covers ``trace_requests`` whole
registrations under the profiler, and a synchronised span times
``classical.prepare_pair`` on a request's clouds.

Afterwards the reference (``portbench/reference/classical.py``) follows
``check_requests`` registrations drawn from the seed through all their
epochs, from the same clouds and seed: every epoch's loss and chamfer
distance (each block of ``log_every`` epochs, the replays of its graph and
the carry across blocks) and the twist the call returned are compared
with what the program returned.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from portbench import trace as TR
from portbench import traffic as TF
from portbench.counts import kernels as K
from portbench.runners import common
from portbench.reference import classical as RC
from portbench.reference import core

PREPARE_CALLS = 3   # synchronised calls of prepare_pair in a traced run


def settings(cell):
    """The configuration as the reference reads it, with the run's epochs."""
    c = cell.config
    return dict(n_lines=c["n_lines"], num_sample=c["num_sample"], lr=c["lr"],
                lr_halve_every=c["lr_halve_every"], kmin=c["kmin"], kmax=c["kmax"],
                seed=c["seed"], epochs=cell.traffic["epochs"])


def program_config(classical, s, epochs: int):
    """``ClassicalConfig`` as ``register.py`` builds it: log every fifth."""
    return classical.ClassicalConfig(
        n_epochs=epochs, n_lines=s["n_lines"], num_sample=s["num_sample"], lr=s["lr"],
        lr_halve_every=s["lr_halve_every"], kmin=s["kmin"], kmax=s["kmax"],
        log_every=max(epochs // 5, 1), seed=s["seed"], compute_chamfer=True)


def register(classical, cfg, src, tar):
    """One request: (seconds from the call until the twist is on the host,
    what it returned: the twist and every epoch's loss, chamfer and
    validity, whether it finished whole and finite)."""
    t = time.perf_counter()
    params, hist = classical.run(src, tar, cfg, device=common.DEVICE)
    params = params.cpu().numpy()
    dt = time.perf_counter() - t
    whole = (len(hist["loss"]) == cfg.n_epochs and bool(np.isfinite(params).all()))
    out = {k: hist[k].tolist() for k in ("loss", "chamfer", "valid")}
    out["params"] = params.reshape(-1).tolist()
    return dt, out, whole


def run(cell, seed: int, seconds: float, trace: bool, t0: float):
    from a_robust_registration_loss_tpu_torch.train import classical

    s = settings(cell)
    spec = cell.traffic
    cfg = program_config(classical, s, s["epochs"])
    src, tar, _, _ = TF.pair(spec, seed, 0, TF.STREAM_WARMUP)
    classical.run(src, tar, dataclasses.replace(cfg, n_epochs=2 * cfg.log_every),
                  device=common.DEVICE)
    common.sync()
    common.reset_peak()
    setup_s = time.perf_counter() - t0

    done, window = [], None
    if trace:
        before = common.launches()
        with TR.Window() as w:
            for i in range(spec["trace_requests"]):
                a, b, _, _ = TF.pair(spec, seed, i)
                done.append(register(classical, cfg, a, b))
        window = w.digest()
        window["counted"] = {k: v - before[k] for k, v in common.launches().items()}
        wall = window["window_s"]
    else:
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds:
            a, b, _, _ = TF.pair(spec, seed, i)
            done.append(register(classical, cfg, a, b))
            i += 1
        wall = time.perf_counter() - start
    memory = common.peak()
    epochs = sum(cfg.n_epochs for _, _, whole in done if whole)
    e2e = {"register_pair_iters_per_s": epochs / wall, "setup_s": setup_s}
    times = [dt for dt, _, _ in done]
    if len(times) >= 2:
        e2e["register_s_p75"] = statistics.quantiles(times, n=4)[2]

    if trace:
        a, b, _, _ = TF.pair(spec, seed, 0)
        spans = []
        for _ in range(PREPARE_CALLS):
            common.sync()
            t = time.perf_counter()
            classical.prepare_pair(a, b, cfg, device=common.DEVICE)
            common.sync()
            spans.append(time.perf_counter() - t)
        window["prepare_ms"] = 1e3 * sum(spans) / len(spans)
    common.free()

    t = time.perf_counter()
    values = check(cell, s, seed, done)
    check_s = time.perf_counter() - t
    if trace:
        counted(window, cell, s, seed)
    return dict(e2e=e2e, digest=window, checks=common.checks(values, cell.limits),
                attempted=len(done), failed=sum(not whole for _, _, whole in done),
                memory_peak_bytes=memory, check_s=check_s)


def check(cell, s, seed: int, done):
    """The reference against the program on the registrations drawn from
    the seed, each followed through all its epochs: the largest relative
    gap of an epoch's loss and chamfer distance, the relative gap of the
    returned twist, and the requests that did not finish whole."""
    values = {"loss_gap": 0.0, "chamfer_gap": 0.0, "twist_gap": 0.0,
              "unfinished": float(sum(not whole for _, _, whole in done))}
    for i in common.sample(seed, len(done), cell.traffic["check_requests"]):
        a, b, _, _ = TF.pair(cell.traffic, seed, i)
        ref = RC.follow(a, b, s, s["epochs"], common.DEVICE)
        gap(values, done[i][1], ref)
    return values


def gap(values, got, ref):
    """Fold one registration's gaps, ``got`` against ``ref`` (each with
    every epoch's loss, chamfer and validity, and the twist), into
    ``values``: a missing epoch or a validity that differs is a gap of
    inf."""
    if len(got["loss"]) != len(ref["loss"]) or got["valid"] != ref["valid"]:
        values["loss_gap"] = float("inf")
    for e in range(min(len(got["loss"]), len(ref["loss"]))):
        for key, name in (("loss", "loss_gap"), ("chamfer", "chamfer_gap")):
            values[name] = max(values[name], common.rel_gap(got[key][e], ref[key][e]))
    p, q = np.asarray(got["params"], np.float64), np.asarray(ref["params"], np.float64)
    twist = (float(np.linalg.norm(p - q) / max(np.linalg.norm(q), 1e-30))
             if np.isfinite(p).all() and np.isfinite(q).all() else float("inf"))
    values["twist_gap"] = max(values["twist_gap"], twist)


def counted(d, cell, s, seed: int):
    """The counted work of the traced registrations beside the trace: the
    operations and bytes of one stage-1 launch, and of one resampler
    launch with its target-box hits read off the first epoch's candidates
    of each traced request by the reference (the box and the sphere are
    the run's own; only the uniforms change between epochs)."""
    n, F = s["n_lines"], s["num_sample"]
    d["stage1_ops"], d["stage1_bytes"] = K.stage1(1, n, F, F, s["kmax"])
    shares = []
    for i in range(cell.traffic["trace_requests"]):
        a, b, _, _ = TF.pair(cell.traffic, seed, i)
        gen = torch.Generator(device=common.DEVICE)
        gen.manual_seed(s["seed"])
        RC.start_twist(gen)
        u4 = torch.rand((4, core.ROUNDS * n), generator=gen, device=common.DEVICE)
        tar = torch.as_tensor(b, device=common.DEVICE)
        tar = tar - tar.mean(0, keepdim=True)
        box = core.box_corners(tar[None])[0]
        r = torch.linalg.vector_norm(box[0] - box[-1])
        cand = core.candidates(u4[None], r[None], tar.mean(0)[None])
        shares.append(float(core.mesh_hit(core.box_faces(tar[None]), cand).float().mean()))
    C = core.ROUNDS * n
    d["resample_ops"], d["resample_bytes"] = K.resample(1, C, C * float(np.mean(shares)))
    d["stage1_kernel"], d["resample_kernel"] = "stage1_kernel", "resample_kernel"
