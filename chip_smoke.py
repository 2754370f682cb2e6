#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Drives the port's two paths on the card:

- the classical registration step at the bench configuration: two
  4,096-point clouds (a synthetic Fibonacci ellipsoid pair made from seed 0),
  2,048 FPS neighbourhoods per cloud and 20,000 lines per step kept from
  200,000 candidates;
- the batched metric API and the trainers' loss glue at BASELINE config 2
  (``benchmarks/bench_loss.py``'s defaults): 32 synthetic pairs of a
  1,024-point Fibonacci sphere with 0.01 noise from seed 0, 1,024 FPS + 3-NN
  neighbourhoods per cloud, 5,000 lines per sample from ``batch_lines`` at
  radius scale 0.5.

Phases:

1. the card's name and power limit (nvidia-smi);
2. build of every CUDA kernel from the sources in the checkout;
3. the fp32 rate probe, held bit for bit to its plain version, then timed:
   its rate is the denominator of every operation bound below, beside the
   data sheet's 67 TFLOP/s (which counts an FMA as two operations; the
   kernels are built without FMA);
4. each kernel against its plain version on the card: stage 1 in pts mode
   and the resampler at the classical path's width and a ragged shape, and
   stage 1 in every mode combination, one and two clouds, unbatched and
   batched, at config 2's width and a ragged shape, a batched launch equal
   to B single launches; each with its time (the kernel's device time from
   torch.profiler, the wrapper call's time back to back from CUDA events),
   its plain version's time (CUDA events) and its bounds (the larger of
   bytes over 3.35 TB/s and fp32 operations over the measured rate, and over
   67 TFLOP/s);
5. the classical path: ``prepare_pair``, then ``make_step`` for 50 warm-up
   and 200 timed epochs, one launch of each of its kernels per epoch, a
   20-step profile that fails on a host copy or wait, and the kernel path
   against the plain path on the CPU at 2,000 lines;
6. the batched path, each call one launch for all 32 samples: first
   ``bench_loss.py``'s objective alone, the forward and gradient of the
   masked mean of ``intersection_loss_batch`` with respect to the source
   neighbourhoods (pts pair); then an iteration of every call of the slice:
   the stage-1 API with its defaults (d2 + recon pair),
   ``find_intersections`` (d2, one cloud), that objective, and
   ``_metric_batch_rt``'s forward and gradient with respect to 32 twists
   (pts pair). Each 2 warm-up and 20 timed iterations and a 5-iteration
   profile that fails on a host copy or wait; both
   losses and gradients against the CPU's plain path on 4 samples and 1,000
   lines (the neighbourhood gradient added onto the source points it
   copies: see ``to_points``).

Every phase that drives a path sets the launch counters to 0 just before
and reads them just after. Stage 1 is counted per template instantiation
(``STAGE1``), so the entries' launches add up to the launches made. Prints one JSON object of the kernels on the
line before the last, and as its last line ``{"ok": true, "device":
{...}}``. Any failed check raises and the exit code is not 0. Without a
CUDA device it exits 1 before any work.
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
B2, N2, F2, L2 = 32, 1024, 1024, 5000  # BASELINE config 2
WARMUP2, TIMED2, PROFILED2 = 2, 20, 5
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
PEAK_FP32_OPS = 67e12   # H100 SXM data sheet, fp32 outside the tensor cores (FMA = 2)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes per second
MODES = [(d2, recon, pts) for d2 in (False, True) for recon in (False, True)
         for pts in (False, True)]
STAGE1 = {  # kernel entry -> the stage1_kernel instantiation (clouds, d2, recon, pts)
    "stage1_pair_pts": (2, False, False, True),      # the classical step, the losses
    "stage1_d2": (1, True, False, False),            # find_intersections
    "stage1_pair_d2_recon": (2, True, True, False),  # intersect_stage1_pair's defaults
}
PTS = dict(emit_d2=False, emit_recon=False, emit_pts=True)
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


def synthetic_batch(B=B2, n=N2):
    """benchmarks/bench_loss.py's pairs: a Fibonacci unit sphere plus 0.01
    noise, B sources then B targets, from seed 0."""
    rng = np.random.default_rng(0)
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    th = np.pi * (1 + 5**0.5) * i
    base = np.stack([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th),
                     np.cos(phi)], -1).astype(np.float32)
    src = np.stack([base + rng.standard_normal(base.shape).astype(np.float32) * 0.01
                    for _ in range(B)])
    tar = np.stack([base + rng.standard_normal(base.shape).astype(np.float32) * 0.01
                    for _ in range(B)])
    return src, tar


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
    """Mean device time of the kernel whose name holds ``kernel`` per call
    of fn over reps calls, read from torch.profiler. Back to back, a
    wrapper's host work can outlast its kernel, and CUDA events around the
    calls would then time the host."""
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


def bounds(ops, nbytes, rate):
    """The least time for ops fp32 operations and nbytes moved: against the
    measured fp32 rate and against the data sheet's. Returns (ms, bound_by)
    for each."""
    t_bytes = nbytes / PEAK_BYTES
    out = []
    for peak in (rate, PEAK_FP32_OPS):
        t_ops = ops / peak
        out.append((1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))
    return out


def entry(name, source, replaces, err, ms, call_ms, plain_ms, ops, nbytes, rate,
          library_ms=None, **extra):
    """One kernel's record: ``bound_ms`` against the data sheet (the least
    time the card could take), ``bound_ms_measured_rate`` against the rate
    the probe measured (what FMA-free code can reach)."""
    (mb, mby), (db, dby) = bounds(ops, nbytes, rate)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=db, bound_by=dby, bound_ms_measured_rate=mb,
                bound_by_measured_rate=mby, library_ms=library_ms, **extra)


def counts(IK, RS, PB, reset=False):
    """The launch counters by kernel entry of the JSON line, plus
    ``stage1_other``, the stage-1 launches of any other instantiation;
    zeroes them when ``reset``."""
    if reset:
        IK.launches.clear()
        RS.launches = PB.launches = 0
    out = {name: IK.launches[IK.instantiation(*key)] for name, key in STAGE1.items()}
    out["stage1_other"] = sum(IK.launches.values()) - sum(out.values())
    out.update(resample_sample_and_hit=RS.launches, probe_fp32_rate=PB.launches)
    return out


def check_counts(launches, want, n, what):
    """Each counter equals want[name] * n (0 where want has no name)."""
    for name, count in launches.items():
        w = want.get(name, 0) * n
        check(count == w, f"{what} {name}: {count} launches in {n} calls (want {w})")


def probe_phase(torch, PB):
    """The rate probe: bit for bit against its plain version at 2 x 16
    steps, then its rate at bench.py's shape (the path that measures the
    roofline). Returns (entry, rate, launches)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2)
    err = 0.0
    for x in (torch.ones(PB.N, device=DEV),
              torch.rand(100_003, generator=gen, device=DEV) * 0.6 + 0.05):
        got, ref = PB.logistic_map(x, 2), PB.logistic_map_reference(x, 2)
        check(torch.equal(got, ref), f"probe: n={x.shape[0]} differs from the plain version")
        err = max(err, float((got - ref).abs().max()))
    print("probe: logistic map equals its plain version bit for bit "
          f"({PB.CHAINS} chains, 2 x {PB.UNROLL} steps)", flush=True)
    n, iters = PB.N, PB.ITERS
    PB.launches = 0
    rate, ms = PB.measured_fp32_rate(DEV)
    launches = PB.launches
    x = torch.ones(n, device=DEV)
    plain = cuda_ms(torch, lambda: PB.logistic_map_reference(x, iters), 1, warmup=0)
    ops = PB.operations(n, iters)
    print(f"probe: {rate / 1e12:.4f} T fp32 ops/s measured ({ms:.4f} ms per call of "
          f"{ops / 1e9:.1f} G ops), against the data sheet's {PEAK_FP32_OPS / 1e12:.0f} T "
          f"({rate / PEAK_FP32_OPS:.1%}); plain version {plain:.1f} ms", flush=True)
    e = entry("probe_fp32_rate", "a_robust_registration_loss_tpu_torch/csrc/probe.cu",
              "bench.py:174", err, ms, ms, plain, ops, 8 * n, rate,
              measured_ops_per_s=rate)
    return e, rate, launches


def stage1_phase(torch, M, IK, data, lines, rate):
    """The classical path's check: stage 1 in pts mode, both clouds, at its
    path's width and at a ragged shape."""
    n1, n2 = data["neis_src"], data["neis_tar"]
    cases = {"full": (n1, n2, lines), "ragged": (n1[:333], n2[:301], lines[:257])}
    err = 0.0
    for name, (a, b, ls) in cases.items():
        d1, d2 = M.neighborhood_delta(a), M.neighborhood_delta(b)
        got = IK.stage1((a, b), ls, (d1, d2), **PTS)
        ref = IK.stage1_reference((a, b), ls, (d1, d2), **PTS)
        torch.cuda.synchronize()
        for g, r, what in zip(got, ref, ("count", "slot_idx", "d2", "recon", "slot_pts")):
            check((g is None and r is None) or torch.equal(g, r),
                  f"stage1 {name}: {what} differs from the plain version")
        err = max(err, float((got[4] - ref[4]).abs().max()))
        print(f"stage1 {name}: F=({a.shape[0]}, {b.shape[0]}) L={ls.shape[0]} "
              f"hits={int(got[0].sum())} max count={int(got[0].max())}: "
              "count, slot_idx, slot_pts equal", flush=True)
    d1, d2 = M.neighborhood_delta(n1), M.neighborhood_delta(n2)
    L, F = lines.shape[0], n1.shape[0] + n2.shape[0]
    def call():
        return IK.stage1((n1, n2), lines, (d1, d2), **PTS)

    ms = kernel_ms(torch, call, 20, "stage1_kernel")
    call_ms = cuda_ms(torch, call, 20)
    plain = cuda_ms(torch, lambda: IK.stage1_reference((n1, n2), lines, (d1, d2), **PTS),
                    2, warmup=1)
    k = IK.KMAX
    nbytes = L * 24 + F * 40 + 2 * L * (4 + 4 * k + 36 * k)
    return entry("stage1_pair_pts", "a_robust_registration_loss_tpu_torch/csrc/intersect.cu",
                 "a_robust_registration_loss_tpu/ops/pallas/intersect.py:56", err, ms,
                 call_ms, plain, L * F * IK.OPS_PER_PAIR, nbytes, rate)


def _narrow_clouds(IK, out, clouds):
    """Raw stage-1 outputs of a two-cloud run -> those of its first
    ``clouds`` clouds."""
    return tuple(None if x is None else x.narrow(axis, 0, clouds)
                 for axis, x in zip(IK.CLOUD_AXIS, out))


def stage1_modes_phase(torch, M, IK, n1, n2, lines, rate):
    """Every mode combination, one and two clouds, at config 2's width and
    at a ragged shape: the batched launch equals the plain version and B
    single (unbatched) launches bit for bit. Then the time at config 2 of
    each instantiation in ``STAGE1``. Returns {entry name: fields}."""
    cases = {"config2": (n1, n2, lines),
             "ragged": (n1[:3, :333], n2[:3, :301], lines[:3, :257])}
    err = {"d2": 0.0, "recon": 0.0, "pts": 0.0}  # largest |kernel - plain| by output
    for case, (a, b, ls) in cases.items():
        deltas = (M.neighborhood_delta(a), M.neighborhood_delta(b))
        ref = IK.stage1_reference((a, b), ls, deltas, emit_d2=True, emit_recon=True,
                                  emit_pts=True)
        for flags in MODES:
            for clouds in (1, 2):
                neis, dl = (a, b)[:clouds], deltas[:clouds]
                kw = dict(emit_d2=flags[0], emit_recon=flags[1], emit_pts=flags[2])
                got = IK.stage1(neis, ls, dl, **kw)
                want = _narrow_clouds(IK, ref, clouds)
                for name, on, g, r in zip(("count", "slot_idx", "d2", "recon", "pts"),
                                          (True, True, *flags), got, want):
                    check((g is None) == (not on), f"stage1 {case}: {name} present iff its mode is on")
                    if g is None:
                        continue
                    check(torch.equal(g, r), f"stage1 {case} {flags} clouds={clouds}: "
                          f"{name} differs from the plain version")
                    if name in err:
                        err[name] = max(err[name], float((g - r).abs().max()))
                for s in range(ls.shape[0]):
                    one = IK.stage1(tuple(n[s] for n in neis), ls[s], tuple(d[s] for d in dl), **kw)
                    for g, o in zip(got, one):
                        check(g is None or torch.equal(g[s], o),
                              f"stage1 {case} {flags}: sample {s} of the batched launch "
                              "differs from its single launch")
        print(f"stage1 modes {case}: B={ls.shape[0]} F=({a.shape[1]}, {b.shape[1]}) "
              f"L={ls.shape[1]} hits={int(ref[0].sum())}: all 8 mode combinations x 1 and 2 "
              "clouds equal the plain version, and each batched launch its "
              f"{ls.shape[0]} single launches, bit for bit", flush=True)

    B, L, F = lines.shape[0], lines.shape[1], n1.shape[1]
    d1, d2 = M.neighborhood_delta(n1), M.neighborhood_delta(n2)
    k = IK.KMAX
    out = {}
    for name, (C, *flags) in STAGE1.items():
        neis, dl = (n1, n2)[:C], (d1, d2)[:C]
        kw = dict(emit_d2=flags[0], emit_recon=flags[1], emit_pts=flags[2])
        def call():
            return IK.stage1(neis, lines, dl, **kw)

        count = call()[0]
        stored = int(torch.clamp_max(count, k).sum())
        ms = kernel_ms(torch, call, 20, "stage1_kernel")
        call_ms = cuda_ms(torch, call, 20)
        plain = cuda_ms(torch, lambda: IK.stage1_reference(neis, lines, dl, **kw), 1, warmup=1)
        ops = B * L * F * C * IK.OPS_PER_PAIR + (IK.OPS_PER_RECON_SLOT * stored if flags[1] else 0)
        per_row = 4 + 4 * k + 12 * k * flags[0] + 12 * k * flags[1] + 36 * k * flags[2]
        nbytes = B * L * 24 + B * F * C * 40 + B * C * L * per_row
        e = max(x for x, on in zip(err.values(), flags) if on)
        out[name] = dict(err=e, ms=ms, call_ms=call_ms, plain_ms=plain, ops=ops,
                         nbytes=nbytes, shape=f"B={B} clouds={C} F={F} L={L}")
        print(f"{name} at config 2 ({out[name]['shape']}): kernel {ms:.4f} ms, "
              f"call {call_ms:.4f} ms, plain {plain:.3f} ms", flush=True)
    return out


def resample_phase(torch, G, RS, data, gen, rate):
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
    return entry("resample_sample_and_hit", "a_robust_registration_loss_tpu_torch/csrc/resample.cu",
                 "a_robust_registration_loss_tpu/ops/pallas/resample.py:43", err, ms, call_ms,
                 plain, C * RS.OPS_PER_CANDIDATE, C * 41 + 24 * 16 * 4 + 16, rate)


def profile_phase(torch, one, n, what, ms_per):
    """Where the time of ``n`` calls of ``one`` (a step or an iteration)
    goes, under torch.profiler. Prints the kernels per call, the device time
    per call and its share of the unprofiled ms per call, and the costliest
    device operations. Fails if a call copies between host and device or
    waits for the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function("chip_smoke.call"):
                one()
        torch.cuda.synchronize()
    events = prof.events()
    # syncs inside the calls, not the profiler's own at the window's edges
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "chip_smoke.call" and e.device_type != DeviceType.CUDA]
    syncs = {s: sum(e.name == s and any(a <= e.time_range.start < b for a, b in spans)
                    for e in events)
             for s in SYNC_CALLS}
    by_name = {}
    for e in events:
        # the annotation also shows on the device, spanning its kernels
        if e.device_type == DeviceType.CUDA and e.name != "chip_smoke.call":
            tot, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), calls + 1)
    copies = sum(c for k, (_, c) in by_name.items()
                 if k.startswith(("Memcpy HtoD", "Memcpy DtoH")))
    kernels = sum(c for k, (_, c) in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    busy = sum(t for t, _ in by_name.values()) / 1e3 / n
    if not by_name:
        print("profile: no device activity recorded; device time not measured",
              flush=True)
    else:
        print(f"profile over {n} {what}s: {kernels / n:.1f} kernels/{what}, "
              f"device time {busy:.4f} ms/{what} = {busy / ms_per:.1%} of "
              f"{ms_per:.4f} ms/{what}; host<->device copies {copies}; sync calls "
              f"{syncs}", flush=True)
        for name, (tot, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"  {tot / 1e3 / n:9.4f} ms/{what} {calls / n:6.1f}/{what}  "
                  f"{name[:90]}", flush=True)
    check(copies == 0, f"{copies} host<->device copies in {n} {what}s")
    check(not any(syncs.values()), f"the {what} waits for the device: {syncs}")


def main_path(torch, classical, se3, G, M, IK, RS, PB, LN, data, cfg):
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
    counts(IK, RS, PB, reset=True)
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
    launches = counts(IK, RS, PB)

    losses = torch.stack(losses).cpu().numpy()
    valids = torch.stack(valids).cpu().numpy()
    n = WARMUP + TIMED
    check(losses.shape == (n,) and np.isfinite(losses).all(), "a loss is not finite")
    check(valids.all(), "an epoch had no usable line")
    check_counts(launches, {"stage1_pair_pts": 1, "resample_sample_and_hit": 1}, n,
                 "classical path")
    chamfer = [float(G.chamfer_distance(s[None], data["tar"][None]))
               for s in (src_first, carry[2])]
    ms = 1e3 * dt / TIMED
    print(f"main path: {n} epochs, F={data['neis_src'].shape[0]}, L={cfg.n_lines}: "
          f"{ms:.4f} ms/step, {TIMED / dt:.2f} it/s over the last {TIMED}; loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, chamfer {chamfer[0]:.6g} -> "
          f"{chamfer[1]:.6g}; launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    state = {"carry": carry}

    def one_step():
        state["carry"], _ = step(state["carry"],
                                 torch.rand((4, n_cand), generator=gen, device=DEV))

    profile_phase(torch, one_step, PROFILED, "step", ms)
    carry = state["carry"]

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


def batch_data(torch, G, LS):
    """Config 2 on the card: neighbourhoods (B, F, 9) of both clouds and
    (B, L, 6) lines from ``batch_lines`` at DCP's radius scale 0.5 around
    each target's mean (``bench_loss.py`` draws them at radius 2.2 around
    the origin)."""
    src, tar = (torch.tensor(x, device=DEV) for x in synthetic_batch(B2, N2))
    t0 = time.perf_counter()
    n1 = G.sample_neighs(src, F2, 3).reshape(B2, F2, 9)
    n2 = G.sample_neighs(tar, F2, 3).reshape(B2, F2, 9)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    u4 = torch.rand((B2, 4, 10 * L2), generator=gen, device=DEV)
    lines = LS.batch_lines(u4, G.bounding_box_corners(tar), tar.mean(1), L2, src, tar,
                           radius_scale=0.5)
    torch.cuda.synchronize()
    filled = float((lines.abs().sum(-1) > 0).float().mean())
    print(f"config 2 data: B={B2} N={N2} F={F2} L={L2}, {filled:.2%} of the lines filled, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(filled > 0.9, f"batch_lines filled only {filled:.2%} of the lines")
    return src, n1, n2, lines


def to_points(g, neis, pts):
    """A gradient with respect to the neighbourhood rows (B, F, 9) -> the
    same gradient added onto the points (B, N, 3) each row copies. At F = N
    mutual nearest neighbours give duplicated neighbourhoods (the same three
    points in another order), whose slot points tie to the last bit, so
    which duplicate row receives a slot's gradient turns on one rounding;
    the gradient on the points does not."""
    out = np.zeros(pts.shape, np.float64)
    for b in range(pts.shape[0]):
        lut = {tuple(p): i for i, p in enumerate(pts[b])}
        idx = np.array([lut[tuple(p)] for p in neis[b].reshape(-1, 3)])
        np.add.at(out[b], idx, g[b].reshape(-1, 3))
    return out




def batch_path(torch, M, IK, RS, PB, LS, se3, src, n1, n2, lines):
    """The batched metric API and the trainers' glue at config 2:
    ``bench_loss.py``'s objective alone, then the iteration of every call,
    each 2 + 20 iterations with the launch counters and a 5-iteration
    profile; then the card against the CPU's plain path on 4 samples and 1,000 lines.
    Returns the launches per kernel of each run: (objective, iteration)."""
    cfg = LS.LossConfig(n_lines=L2)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    twists = (torch.rand((B2, 6), generator=gen, device=DEV) - 0.5) * 0.06

    def objective(n1, n2, lines):
        """bench_loss.py's: the forward and gradient of the masked mean of
        intersection_loss_batch with respect to the source neighbourhoods."""
        a = n1.detach().requires_grad_(True)
        losses, valid = M.intersection_loss_batch(a, n2, lines)
        (g,) = torch.autograd.grad(torch.where(valid, losses, 0.0).mean(), a)
        return dict(losses=losses.detach(), valid=valid, g=g)

    def iteration(n1, n2, lines, twists):
        api = IK.intersect_stage1_pair(n1, n2, lines, M.neighborhood_delta(n1),
                                       M.neighborhood_delta(n2))
        inter = M.find_intersections(n1, lines)
        out = objective(n1, n2, lines)
        p = twists.detach().requires_grad_(True)
        R, t = se3.exp3(p)
        per = LS._metric_batch_rt(R, t, n1, n2, lines, cfg)
        (gp,) = torch.autograd.grad(per.sum() / p.shape[0], p)
        return dict(out, api_count=api[0][0], count=inter.count, per=per.detach(), gp=gp)

    def run(fn, want, what):
        """2 + 20 calls of fn between counter reset and read -> (last
        output, ms per call over the 20, launches)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts(IK, RS, PB, reset=True)
        for _ in range(WARMUP2):
            out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED2):
            out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / TIMED2
        launches = counts(IK, RS, PB)
        n = WARMUP2 + TIMED2
        check_counts(launches, want, n, what)
        for key in ("losses", "per", "g", "gp"):
            check(key not in out or bool(torch.isfinite(out[key]).all()),
                  f"{what}: {key} not finite")
        check(bool(out["valid"].all()) and ("per" not in out or bool((out["per"] > 0).all())),
              f"{what}: a sample has no usable line")
        print(f"{what}: {n} iterations at B={B2} F={F2} L={L2}: {ms:.4f} ms/iteration over "
              f"the last {TIMED2}; mean loss {float(out['losses'].mean()):.6f}"
              + (f", mean rigid loss {float(out['per'].mean()):.6f}" if "per" in out else "")
              + f"; launches per iteration { {k: v / n for k, v in launches.items() if v} }; "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
        return out, ms, launches

    _, ms_obj, obj = run(lambda: objective(n1, n2, lines), {"stage1_pair_pts": 1},
                         "bench_loss objective (intersection_loss_batch forward + gradient)")
    profile_phase(torch, lambda: objective(n1, n2, lines), PROFILED2, "objective", ms_obj)
    out, ms, mix = run(lambda: iteration(n1, n2, lines, twists),
                       {"stage1_d2": 1, "stage1_pair_d2_recon": 1, "stage1_pair_pts": 2},
                       "batched path (every call of the slice)")
    check(torch.equal(out["api_count"], out["count"]),
          "the stage-1 API and find_intersections count differently")
    profile_phase(torch, lambda: iteration(n1, n2, lines, twists), PROFILED2, "iteration", ms)

    # the card against the CPU's plain path on 4 samples and 1,000 lines
    res = {}
    for dev in (DEV, "cpu"):
        r = iteration(n1[:4].to(dev), n2[:4].to(dev), lines[:4, :1000].to(dev),
                      twists[:4].to(dev))
        res[dev] = {k: v.cpu().numpy() for k, v in r.items()}
    pts, neis = src[:4].cpu().numpy(), n1[:4].cpu().numpy()
    # the neighbourhood gradient on the source points
    k_, p_ = ({**r, "g": to_points(r["g"], neis, pts)} for r in (res[DEV], res["cpu"]))
    for key, gkey in (("losses", "g"), ("per", "gp")):
        lerr = float(np.max(np.abs(k_[key] - p_[key]) / np.maximum(np.abs(p_[key]), 1e-6)))
        gerr = float(np.linalg.norm(k_[gkey] - p_[gkey]) / max(np.linalg.norm(p_[gkey]), 1e-12))
        print(f"batched path vs plain CPU path at B=4 L=1000: {key} rel err {lerr:.3g}, "
              f"grad rel L2 {gerr:.3g}", flush=True)
        check(p_["valid"].all() and k_["valid"].all(), "no usable line in the parity check")
        check(lerr <= 1e-4, f"batched path {key}: rel err {lerr}")
        check(gerr <= 5e-4, f"batched path {gkey}: gradient rel L2 {gerr}")
    check(np.array_equal(k_["count"], p_["count"]), "batched path: counts differ from the CPU's")
    return obj, mix


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
    from a_robust_registration_loss_tpu_torch.ops.cuda import probe as PB
    from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
    from a_robust_registration_loss_tpu_torch.se3 import se3
    from a_robust_registration_loss_tpu_torch.train import classical
    from a_robust_registration_loss_tpu_torch.train import losses as LS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    print(_build.build_log.strip(), flush=True)

    probe, rate, probe_launches = probe_phase(torch, PB)

    cfg = classical.ClassicalConfig(n_lines=N_LINES, num_sample=N_FACES,
                                    compute_chamfer=False)
    v1, v2 = synthetic_pair()
    t0 = time.perf_counter()
    data = classical.prepare_pair(v1, v2, cfg, device=DEV)
    torch.cuda.synchronize()
    print(f"prepare_pair: {time.perf_counter() - t0:.2f} s, "
          f"F={data['neis_src'].shape[0]}", flush=True)

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    lines = LN.resample_lines(torch.rand((4, LN.ROUNDS * N_LINES), generator=gen, device=DEV),
                              data["radius"], data["center"], N_LINES, data["src"], data["tar"])
    pts = stage1_phase(torch, M, IK, data, lines, rate)
    resample = resample_phase(torch, G, RS, data, gen, rate)
    src2, n1, n2, lines2 = batch_data(torch, G, LS)
    modes = stage1_modes_phase(torch, M, IK, n1, n2, lines2, rate)
    src = "a_robust_registration_loss_tpu_torch/csrc/intersect.cu"
    kernels = [pts] + [
        entry(name, src, "a_robust_registration_loss_tpu/ops/pallas/intersect.py:56",
              m["err"], m["ms"], m["call_ms"], m["plain_ms"], m["ops"], m["nbytes"], rate,
              shape=m["shape"])
        for name, m in modes.items() if name != "stage1_pair_pts"] + [resample, probe]
    p2 = modes["stage1_pair_pts"]
    (mb, _), (db, _) = bounds(p2["ops"], p2["nbytes"], rate)
    pts.update(config2_shape=p2["shape"], config2_ms=p2["ms"], config2_call_ms=p2["call_ms"],
               config2_plain_ms=p2["plain_ms"], config2_bound_ms=db,
               config2_bound_ms_measured_rate=mb,
               max_abs_err=max(pts["max_abs_err"], p2["err"]))
    for k in kernels:
        print(f"{k['name']}: kernel {k['ms']:.4f} ms, wrapper call {k['call_ms']:.4f} ms "
              f"back to back (plain {k['plain_ms']:.3f} ms), bound "
              f"{k['bound_ms_measured_rate']:.5f} ms by {k['bound_by_measured_rate']} at the "
              f"measured rate ({k['bound_ms_measured_rate'] / k['ms']:.1%} of it reached), "
              f"{k['bound_ms']:.5f} ms by {k['bound_by']} at the data sheet's", flush=True)

    classical_launches = main_path(torch, classical, se3, G, M, IK, RS, PB, LN, data, cfg)
    objective, mix = batch_path(torch, M, IK, RS, PB, LS, se3, src2, n1, n2, lines2)
    paths = {"probe": {"probe_fp32_rate": probe_launches}, "classical": classical_launches,
             "bench_loss_objective": objective, "batched_metric": mix}
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items() if c.get(k["name"])}
        k["launches"] = sum(k["launches_by_path"].values())
        check(k["launches"] > 0, f"{k['name']}: launched on no path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_ms_measured_rate", "bound_by_measured_rate", "call_ms",
            "launches_by_path")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  | {key: v for key, v in k.items() if key not in keys}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
