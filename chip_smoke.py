#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Drives the port's main path, the classical registration step, at the
bench configuration: two 4,096-point clouds (a synthetic Fibonacci
ellipsoid pair made from seed 0), 2,048 FPS neighbourhoods per cloud and
20,000 lines per step kept from 200,000 candidates. Phases:

1. the card's name and power limit (nvidia-smi);
2. build of every CUDA kernel from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, at full width
   and at a ragged shape, with its time (the kernel's device time from
   torch.profiler, and the wrapper call's time back to back from CUDA
   events), its plain version's time (CUDA events) and its bound (the
   larger of bytes over 3.35 TB/s and fp32 operations over 67 TFLOP/s, the
   H100 SXM data-sheet peaks);
4. the main path: ``prepare_pair``, then ``make_step`` for 50 warm-up and
   200 timed epochs with the kernels' launch counters reset just before;
   every loss finite, every epoch valid, one launch of each kernel per
   epoch; then 20 more steps under torch.profiler (device time per step,
   the costliest device operations, and a check that a step neither copies
   between host and device nor waits for the device); then the loss and
   gradient of the kernel path against the plain path on the CPU at a
   reduced line count.

Prints one JSON object of the kernels on the line before the last, and as
its last line ``{"ok": true, "device": {...}}``. Any failed check raises and
the exit code is not 0. Without a CUDA device it exits 1 before any work.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N_CLOUD = 4096
N_FACES = 2048
N_LINES = 20000
WARMUP, TIMED = 50, 200
PROFILED = 20  # steps traced after the timed ones
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
PEAK_FP32_OPS = 67e12   # H100 SXM fp32 outside the tensor cores, per second
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes per second
DEV = "cuda"


def synthetic_pair(n=N_CLOUD):
    """bench.py's pair: a noisy Fibonacci ellipsoid, twice, from seed 0."""
    rng = np.random.default_rng(0)
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    th = np.pi * (1 + 5**0.5) * i
    p = np.stack([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th),
                  np.cos(phi)], -1)
    p = (p * np.array([1.0, 0.7, 0.5])).astype(np.float32)
    v1 = p + rng.standard_normal(p.shape).astype(np.float32) * 0.01
    v2 = p + rng.standard_normal(p.shape).astype(np.float32) * 0.01
    return v1, v2


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(torch, fn, reps, warmup=2):
    """Mean ms per call of fn over reps calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(torch, fn, reps, kernel):
    """Mean device time of the kernel named ``kernel`` per call of fn over
    reps calls, read from torch.profiler. Back to back, a wrapper's host
    work can outlast its kernel, and CUDA events around the calls would
    then time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    check(len(times) == reps, f"{kernel}: the profiler saw {len(times)} of {reps} launches")
    return sum(times) / reps / 1e3


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stage1_phase(torch, M, IK, data, lines):
    n1, n2 = data["neis_src"], data["neis_tar"]
    cases = {"full": (n1, n2, lines), "ragged": (n1[:333], n2[:301], lines[:257])}
    err = 0.0
    for name, (a, b, ls) in cases.items():
        d1, d2 = M.neighborhood_delta(a), M.neighborhood_delta(b)
        got = IK.intersect_stage1_pair_pts(a, b, ls, d1, d2)
        ref = IK.intersect_stage1_pair_pts_reference(a, b, ls, d1, d2)
        torch.cuda.synchronize()
        for g, r, what in zip(got, ref, ("count", "slot_idx", "slot_pts")):
            check(torch.equal(g, r), f"stage1 {name}: {what} differs from the plain version")
        err = max(err, float((got[2] - ref[2]).abs().max()))
        print(f"stage1 {name}: F=({a.shape[0]}, {b.shape[0]}) L={ls.shape[0]} "
              f"hits={int(got[0].sum())} max count={int(got[0].max())}: "
              "count, slot_idx, slot_pts equal", flush=True)
    d1, d2 = M.neighborhood_delta(n1), M.neighborhood_delta(n2)
    L, F = lines.shape[0], n1.shape[0] + n2.shape[0]
    def call():
        return IK.intersect_stage1_pair_pts(n1, n2, lines, d1, d2)

    ms = kernel_ms(torch, call, 20, "stage1_pair_kernel")
    call_ms = cuda_ms(torch, call, 20)
    plain = cuda_ms(torch, lambda: IK.intersect_stage1_pair_pts_reference(n1, n2, lines, d1, d2),
                    2, warmup=1)
    k = IK.KMAX
    nbytes = L * 24 + F * 40 + 2 * L * (4 + 4 * k + 36 * k)
    b_ms, b_by = bound_ms(L * F * IK.OPS_PER_PAIR, nbytes)
    return dict(name="stage1_pair_pts", route="cuda",
                source="a_robust_registration_loss_tpu_torch/csrc/intersect.cu",
                replaces="a_robust_registration_loss_tpu/ops/pallas/intersect.py:56",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def resample_phase(torch, G, RS, data, gen):
    fv = RS.prep_faces(G.bbox_face_vertices(data["src"][None])[0],
                       G.bbox_face_vertices(data["tar"][None])[0])
    r, c = data["radius"], data["center"]
    err = 0.0
    for C in (10 * N_LINES, 777):
        u4 = torch.rand((4, C), generator=gen, device=DEV)
        cand, ok = RS.sample_and_hit(u4, r, c, fv)
        cand_r, ok_r = RS.sample_and_hit_reference(u4, r, c, fv)
        e = float((cand - cand_r).abs().max())
        flip = float((ok != ok_r).float().mean())
        acc, acc_r = float(ok.float().mean()), float(ok_r.float().mean())
        print(f"resample C={C}: max |cand - plain| {e:.3g}, labels differ on "
              f"{flip:.5%}, acceptance {acc:.5f} vs plain {acc_r:.5f}", flush=True)
        check(e <= 1e-4, f"resample C={C}: candidate geometry off by {e}")
        check(flip <= 1e-3, f"resample C={C}: {flip:.3%} labels differ")
        check(abs(acc - acc_r) <= 0.1 * max(acc_r, 1e-3),
              f"resample C={C}: acceptance {acc} vs {acc_r}")
        err = max(err, e)
    C = 10 * N_LINES
    u4 = torch.rand((4, C), generator=gen, device=DEV)
    def call():
        return RS.sample_and_hit(u4, r, c, fv)

    ms = kernel_ms(torch, call, 50, "resample_kernel")
    call_ms = cuda_ms(torch, call, 50)
    plain = cuda_ms(torch, lambda: RS.sample_and_hit_reference(u4, r, c, fv), 3, warmup=1)
    b_ms, b_by = bound_ms(C * RS.OPS_PER_CANDIDATE, C * 41 + 24 * 16 * 4 + 16)
    return dict(name="resample_sample_and_hit", route="cuda",
                source="a_robust_registration_loss_tpu_torch/csrc/resample.cu",
                replaces="a_robust_registration_loss_tpu/ops/pallas/resample.py:43",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def profile_phase(torch, step, carry, gen, n_cand, ms_step):
    """Where a step's time goes: PROFILED more steps of the main path under
    torch.profiler. Prints the kernels per step, the device time per step and
    its share of the unprofiled ms/step, and the costliest device
    operations. Fails if a step copies between host and device or waits for
    the device: the step keeps no host sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            with record_function("chip_smoke.step"):
                carry, _ = step(carry, torch.rand((4, n_cand), generator=gen, device=DEV))
        torch.cuda.synchronize()
    events = prof.events()
    # syncs inside the steps: the window's own closing syncs come after them
    steps_end = max(e.time_range.end for e in events if e.name == "chip_smoke.step")
    syncs = {s: sum(e.name == s and e.time_range.start < steps_end for e in events)
             for s in SYNC_CALLS}
    by_name = {}
    for e in events:
        # the step annotation also shows on the device, spanning its kernels
        if e.device_type == DeviceType.CUDA and e.name != "chip_smoke.step":
            tot, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), calls + 1)
    copies = sum(c for k, (_, c) in by_name.items()
                 if k.startswith(("Memcpy HtoD", "Memcpy DtoH")))
    kernels = sum(c for k, (_, c) in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    busy = sum(t for t, _ in by_name.values()) / 1e3 / PROFILED
    if not by_name:
        print("profile: no device activity recorded; device time not measured",
              flush=True)
    else:
        print(f"profile over {PROFILED} steps: {kernels / PROFILED:.1f} kernels/step, "
              f"device time {busy:.4f} ms/step = {busy / ms_step:.1%} of "
              f"{ms_step:.4f} ms/step; host<->device copies {copies}; sync calls "
              f"{syncs}", flush=True)
        for name, (tot, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"  {tot / 1e3 / PROFILED:9.4f} ms/step {calls / PROFILED:6.1f}/step  "
                  f"{name[:90]}", flush=True)
    check(copies == 0, f"{copies} host<->device copies in {PROFILED} steps")
    check(not any(syncs.values()), f"the step waits for the device: {syncs}")
    return carry


def main_path(torch, classical, se3, G, M, IK, RS, LN, data, cfg):
    """prepare_pair's data -> 50 + 200 epochs of make_step, then the
    profiled window; returns the launches per kernel in the 250 epochs."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = classical.init_twist(gen)
    carry = (params, classical.init_adam(params), data["src"])
    step = classical.make_step(cfg, data)
    n_cand = LN.ROUNDS * cfg.n_lines
    losses, valids = [], []

    torch.cuda.reset_peak_memory_stats()
    RS.launches = 0
    IK.launches = 0
    for _ in range(WARMUP):
        carry, m = step(carry, torch.rand((4, n_cand), generator=gen, device=DEV))
        losses.append(m["loss"])
        valids.append(m["valid"])
        if len(losses) == 1:
            src_first = carry[2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        carry, m = step(carry, torch.rand((4, n_cand), generator=gen, device=DEV))
        losses.append(m["loss"])
        valids.append(m["valid"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"resample_sample_and_hit": RS.launches, "stage1_pair_pts": IK.launches}

    losses = torch.stack(losses).cpu().numpy()
    valids = torch.stack(valids).cpu().numpy()
    n = WARMUP + TIMED
    check(losses.shape == (n,) and np.isfinite(losses).all(), "a loss is not finite")
    check(valids.all(), "an epoch had no usable line")
    for name, count in launches.items():
        check(count == n, f"{name}: {count} launches in {n} epochs (want one per epoch)")
    chamfer = [float(G.chamfer_distance(s[None], data["tar"][None]))
               for s in (src_first, carry[2])]
    ms = 1e3 * dt / TIMED
    print(f"main path: {n} epochs, F={data['neis_src'].shape[0]}, L={cfg.n_lines}: "
          f"{ms:.4f} ms/step, {TIMED / dt:.2f} it/s over the last {TIMED}; loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, chamfer {chamfer[0]:.6g} -> "
          f"{chamfer[1]:.6g}; launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    carry = profile_phase(torch, step, carry, gen, n_cand, ms)

    # the kernel path against the plain path on the CPU, at 2,000 lines
    lines = LN.resample_lines(torch.rand((4, LN.ROUNDS * 2000), generator=gen, device=DEV),
                              data["radius"], data["center"], 2000, carry[2], data["tar"])
    out = {}
    for dev in (DEV, "cpu"):
        p = carry[0].detach().to(dev).requires_grad_(True)
        R, t = se3.exp3(p)
        loss, valid = M.intersection_loss_rigid(
            R, t, data["neis_src"].to(dev), data["neis_tar"].to(dev), lines.to(dev))
        (g,) = torch.autograd.grad(loss, p)
        out[dev] = (float(loss.detach()), bool(valid), g.cpu().numpy())
    (lk, vk, gk), (lp, vp, gp) = out[DEV], out["cpu"]
    gerr = float(np.linalg.norm(gk - gp) / max(np.linalg.norm(gp), 1e-12))
    print(f"kernel path vs plain CPU path at L=2000: loss {lk:.7f} vs {lp:.7f}, "
          f"grad rel L2 {gerr:.3g}", flush=True)
    check(vk and vp, "no usable line in the parity check")
    check(abs(lk - lp) <= 1e-4 * max(abs(lp), 1e-6), f"loss {lk} vs plain {lp}")
    check(gerr <= 5e-4, f"gradient rel L2 {gerr}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from a_robust_registration_loss_tpu_torch.ops import geometry as G
    from a_robust_registration_loss_tpu_torch.ops import lines as LN
    from a_robust_registration_loss_tpu_torch.ops import metric as M
    from a_robust_registration_loss_tpu_torch.ops.cuda import _build
    from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
    from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
    from a_robust_registration_loss_tpu_torch.se3 import se3
    from a_robust_registration_loss_tpu_torch.train import classical

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    print(_build.build_log.strip(), flush=True)

    cfg = classical.ClassicalConfig(n_lines=N_LINES, num_sample=N_FACES,
                                    compute_chamfer=False)
    v1, v2 = synthetic_pair()
    t0 = time.perf_counter()
    data = classical.prepare_pair(v1, v2, cfg)
    torch.cuda.synchronize()
    print(f"prepare_pair: {time.perf_counter() - t0:.2f} s, "
          f"F={data['neis_src'].shape[0]}", flush=True)

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    lines = LN.resample_lines(torch.rand((4, LN.ROUNDS * N_LINES), generator=gen, device=DEV),
                              data["radius"], data["center"], N_LINES, data["src"], data["tar"])
    kernels = [stage1_phase(torch, M, IK, data, lines),
               resample_phase(torch, G, RS, data, gen)]
    for k in kernels:
        print(f"{k['name']}: kernel {k['ms']:.4f} ms, wrapper call {k['call_ms']:.4f} ms "
              f"back to back (plain {k['plain_ms']:.3f} ms, "
              f"bound {k['bound_ms']:.5f} ms by {k['bound_by']})", flush=True)

    launches = main_path(torch, classical, se3, G, M, IK, RS, LN, data, cfg)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
