#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Drives the port's paths on the card:

- the classical registration step at the bench configuration: two
  4,096-point clouds (a synthetic Fibonacci ellipsoid pair made from seed 0),
  2,048 FPS neighbourhoods per cloud and 20,000 lines per step kept from
  200,000 candidates;
- the batched metric API and the trainers' loss glue at BASELINE config 2
  (``benchmarks/bench_loss.py``'s defaults): 32 synthetic pairs of a
  1,024-point Fibonacci sphere with 0.01 noise from seed 0, 1,024 FPS + 3-NN
  neighbourhoods per cloud, 5,000 lines per sample from ``batch_lines`` at
  radius scale 0.5;
- DCP's evaluation path at ``DCPConfig``'s defaults (DGCNN with k = 20, one
  transformer block of 4 heads and ff 1,024, the SVD head, 512 embedding
  dimensions, weights from seed 0): 8 batches of 4 synthetic pairs of a
  1,024-point noisy Fibonacci sphere from seed 0, 1,024 FPS + 3-NN
  neighbourhoods per cloud, 15,000 lines per sample.

Phases:

1. the card's name and power limit (nvidia-smi);
2. build of every CUDA kernel from the sources in the checkout;
3. the fp32 rate probe, held bit for bit to its plain version, then timed:
   its rate is the denominator of every operation bound below, beside the
   data sheet's 67 TFLOP/s (which counts an FMA as two operations; the
   kernels are built without FMA);
4. each kernel against its plain version on the card: stage 1 in pts mode
   and the resampler at the classical path's width and a ragged shape (the
   resampler's cand and ok bit for bit, each mesh's hit share and the
   acceptance printed, then the same on every set of
   ``adversarial_cases``), and
   stage 1 in every mode combination, one and two clouds, unbatched and
   batched, at config 2's width and a ragged shape, a batched launch equal
   to B single launches; stage 1's split of the faces into 4 segments at
   ragged F, fewer faces than segments, kmax = 1 and a first segment that
   alone overflows the slots;
   each with its time (the kernel's device time from
   torch.profiler, the wrapper call's time back to back from CUDA events),
   its plain version's time (CUDA events) and its bounds (the larger of
   bytes over 3.35 TB/s and fp32 operations over the measured rate, and over
   67 TFLOP/s; the resampler's operations are those its inputs need when
   mesh 1 is tested only for the hits of mesh 2, with the bound of both
   meshes for every candidate beside it);
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

7. the row gather: forward and backward kernels against their plain
   versions at (B, N, C, Q) = (4, 1,024, 6, 65,536), (4, 1,024, 128,
   65,536) and a ragged (3, 17, 5, 33) with indices out of range: forward
   bit for bit, backward equal to the plain version on the CPU bit for bit
   (the kernel sums in ascending q, as a sequential ``index_add_`` does),
   within 1e-6 x sum |g| of the plain version on the card (whose atomics
   sum in an order of their own), and two launches equal bit for bit; the
   backward's sort equal to its plain version; the backward's time the sum
   of its three kernels, with the split, and the times of
   ``torch.take_along_dim`` and ``index_add_`` beside them; then the
   backward's edge cases with int32 and int64 indices (one row takes every
   query, 5 rows do, indices out of range, all of them out of range);
8. the resampler's batch axis: one launch at B = 4 and 150,000 candidates
   per sample equal to 4 single launches and the plain version bit for
   bit, with each mesh's hit share;
9. the kernels on the DCP path's own data, before the paths' long
   profiles: the gather kernels on the kNN indices of the model's own graph
   (forward equal to the features the model gathered, backward of the
   model's own upstream gradient equal to the plain version's, counted as
   a path of its own); stage 1 as ``dcp_cal_loss`` launches it (both
   clouds, pts mode, B = 4, F = 1,024 per cloud, 15,000 lines) against its
   plain version on the card bit for bit, with its time; and the card
   against the CPU's plain path: R_ab and t_ab within 1e-4, and at 15,000
   lines, the same on both, equal stage-1 counts, then the loss within
   1e-4 relative;
10. the DCP path: ``evaluate`` over the 8 batches (every metric finite,
   ``Eval.json`` and the OBJ dumps written to a temporary directory, one
   resampler and one stage-1 launch per batch), 10 iterations of the
   forward and gradient of ``dcp_train_loss`` through the network to every
   parameter (finite, the SVD head's singular values apart), and
   5-iteration profiles of both that count host copies and waits without
   failing on them.

Every phase that drives a path sets the launch counters to 0 just before
and reads them just after. Stage 1 is counted per template instantiation
(``STAGE1``), so the entries' launches add up to the launches made. Prints
one JSON object of the kernels on the line before the last, and as its
last line ``{"ok": true, "device": {...}}``. Any failed check raises and the
exit code is not 0. Without a CUDA device it exits 1 before any work.
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
TRACE_TRIES = 5  # windows kernel_ms traces before it fails on missing records
B2, N2, F2, L2 = 32, 1024, 1024, 5000  # BASELINE config 2
WARMUP2, TIMED2, PROFILED2 = 2, 20, 5
B3, N3, F3, L3, BATCHES3 = 4, 1024, 1024, 15000, 8  # the DCP path
GRAD_ITERS3, PROFILED3 = 10, 5
GATHER_SHAPES = {"rpm_grouping": (4, 1024, 6, 65536), "wide": (4, 1024, 128, 65536),
                 "ragged": (3, 17, 5, 33)}  # (B, N, C, Q)
# the backward's edge cases, (B, N, C, Q) each with int32 and int64 indices:
# every query on one row, 5 of the rows taking every query, a third of the
# indices out of range, every index out of range; no Q a multiple of a chunk
GATHER_EDGES = {"one_row": (4, 1024, 6, 65537), "sparse_rows": (3, 2000, 3, 20483),
                "out_of_range": (2, 64, 5, 4099), "all_dropped": (1, 9, 4, 130)}
GATHER_BWD_KERNELS = {"hist": "gather_bwd_hist", "place": "gather_bwd_place",
                      "sum": "gather_bwd_sum"}  # the backward's kernels by part of name
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


def kernel_ms(torch, fn, reps, kernel=None, per_call=1, split=None):
    """Mean device time per call of fn over reps calls, read from
    torch.profiler: of the ``per_call`` kernels a call launches once each
    whose names hold ``kernel`` (their times added), or, with no name, of
    everything fn puts on the device (a library call, whose kernels' names
    are not ours to know). Back to back, a wrapper's host work can outlast
    its kernel, and CUDA events around the calls would then time the host.
    Each named kernel must show all of its reps launches, and a library call
    some device activity: the tracer now and then loses the records of a
    window's tail, so a window that shows fewer is traced again, and after
    ``TRACE_TRIES`` windows the check fails.
    ``split``, a dict of {key: part of a kernel's name}, is filled with each
    part's mean ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.name):
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        seen = sum(map(len, by_name.values()))
        whole = len(by_name) == per_call and all(len(us) == reps for us in by_name.values())
        if by_name if kernel is None else whole:
            break
        print(f"{kernel or 'the library call'}: the profiler saw {seen} of "
              f"{reps * per_call} launches; tracing again", flush=True)
    if kernel is None:
        check(by_name, "the profiler saw no device activity of the library call")
    else:
        check(whole, f"{kernel}: the profiler saw {seen} of {reps * per_call} launches of "
              f"{per_call} kernels in each of {TRACE_TRIES} windows")
    ms = {name: sum(us) / reps / 1e3 for name, us in by_name.items()}
    if split is not None:
        for key, part in list(split.items()):
            split[key] = sum(t for name, t in ms.items() if part in name)
    return sum(ms.values())


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
    from a_robust_registration_loss_tpu_torch.ops.cuda import gather as GK

    if reset:
        IK.launches.clear()
        RS.launches.clear()
        PB.launches = 0
        GK.launches.update(fwd=0, bwd_sort=0, bwd_sum=0)
    out = {name: IK.launches[IK.instantiation(*key)] for name, key in STAGE1.items()}
    out["stage1_other"] = sum(IK.launches.values()) - sum(out.values())
    out.update(resample_sample_and_hit=RS.launches["single"],
               resample_batched=RS.launches["batched"], probe_fp32_rate=PB.launches,
               gather_fwd=GK.launches["fwd"], gather_bwd=GK.launches["bwd_sum"])
    check(GK.launches["bwd_sort"] == GK.launches["bwd_sum"],
          f"the gather's backward sorted and summed unequally often: {GK.launches}")
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


def dense_first_faces(torch, neis, lines, copies=6):
    """Make the first ``copies`` faces of every sample one equilateral
    triangle of side 0.2 and send every line through its centroid: each line
    then hits all of them, whatever its direction (the vertices lie 0.115
    from the centroid, under the threshold 0.8655 * 0.2)."""
    c = torch.tensor([0.3, -0.2, 0.6], device=neis.device)
    tri = c + 0.2 / 3**0.5 * torch.tensor([[1.0, 0.0, 0.0], [-0.5, 0.75**0.5, 0.0],
                                           [-0.5, -(0.75**0.5), 0.0]], device=neis.device)
    neis, lines = neis.clone(), lines.clone()
    neis[..., :copies, :] = tri.reshape(9)
    lines[..., 3:] = c
    return neis, lines


def stage1_segments_phase(torch, M, IK, n1, n2, lines):
    """Stage 1's split of the faces into segments and their merge, on one
    sample and on all 32 samples of config 2's lines, every mode on,
    against the plain version bit for bit: ragged F (no multiple of a step
    or of the segments), fewer faces than segments, kmax = 1, and a first
    segment that alone holds more than kmax hits of every line."""
    B = lines.shape[0]
    for a, b, ls in ((n1[0], n2[0], lines[0, :257]), (n1, n2, lines)):
        a, b = a[..., :333, :], b[..., :301, :]
        nb = B if ls.dim() == 3 else 1
        dense, through = dense_first_faces(torch, a, ls)
        cases = {"ragged": (a, b, ls, 4), "kmax=1": (a, b, ls, 1),
                 "fewer faces than segments": (a[..., :3, :], b[..., :2, :], ls, 4),
                 "dense first segment": (dense, b, through, 4)}
        for name, (x, y, l6, kmax) in cases.items():
            deltas = (M.neighborhood_delta(x), M.neighborhood_delta(y))
            kw = dict(emit_d2=True, emit_recon=True, emit_pts=True)
            got = IK.stage1((x, y), l6, deltas, kmax, **kw)
            ref = IK.stage1_reference((x, y), l6, deltas, kmax, **kw)
            for g, r, what in zip(got, ref, ("count", "slot_idx", "d2", "recon", "slot_pts")):
                check(torch.equal(g, r),
                      f"stage1 B={nb} {name}: {what} differs from the plain version")
            if name == "dense first segment":
                least = int(ref[0].select(-2, 0).min())
                check(least > kmax, f"stage1 B={nb} {name}: a line has only {least} hits")
            print(f"stage1 segments B={nb} {name}: F=({x.shape[-2]}, {y.shape[-2]}) "
                  f"L={l6.shape[-2]} kmax={kmax} hits={int(ref[0].sum())} max count="
                  f"{int(ref[0].max())}: every output equals the plain version", flush=True)


def resample_check(torch, RS, u4, r, c, fv, what):
    """One launch against the plain version: cand and ok equal bit for bit,
    the acceptance rates within 10% (the JAX package's bar between its own
    paths, kept beside the exact one). Returns the largest difference of
    cand or ok and the plain version's counts: hits of mesh 1, hits of
    mesh 2, accepted, candidates."""
    before = RS.launches.copy()
    cand, ok = RS.sample_and_hit(u4, r, c, fv)
    check(sum((RS.launches - before).values()) == 1, f"resample {what}: not one launch")
    cand_r, ok_r = RS.sample_and_hit_reference(u4, r, c, fv)
    h1 = int(RS._mesh_hit(fv[..., :RS.NF, :], cand_r).sum())
    h2 = int(RS._mesh_hit(fv[..., RS.NF:, :], cand_r).sum())
    check(torch.equal(cand, cand_r), f"resample {what}: cand differs from the plain version")
    check(torch.equal(ok, ok_r), f"resample {what}: {int((ok != ok_r).sum())} labels differ "
          "from the plain version")
    acc, acc_r = float(ok.float().mean()), float(ok_r.float().mean())
    check(abs(acc - acc_r) <= 0.1 * max(acc_r, 1e-3), f"resample {what}: acceptance {acc} vs {acc_r}")
    err = max(float((cand - cand_r).abs().max()), float((ok.int() - ok_r.int()).abs().max()))
    return err, h1, h2, int(ok_r.sum()), ok.numel()


def resample_adversarial(torch, RS):
    """``RS.adversarial_cases``: the kernel equals its plain version bit for
    bit on each, and each batched launch its single launches."""
    for name, (u4, r, c, f1, f2) in RS.adversarial_cases(DEV).items():
        fv = RS.prep_faces(f1, f2)
        _, h1, h2, acc, n = resample_check(torch, RS, u4, r, c, fv, f"adversarial {name}")
        if u4.dim() == 3:
            cand, ok = RS.sample_and_hit(u4, r, c, fv)
            for b in range(u4.shape[0]):
                one = RS.sample_and_hit(u4[b], r[b], c[b], fv[b])
                check(torch.equal(cand[b], one[0]) and torch.equal(ok[b], one[1]),
                      f"resample adversarial {name}: sample {b} differs from its single launch")
        print(f"resample adversarial {name} {tuple(u4.shape)}: cand and ok equal the plain "
              f"version bit for bit; mesh 1 {h1 / n:.4f}, mesh 2 {h2 / n:.4f}, accepted "
              f"{acc / n:.4f}", flush=True)


def resample_entry(torch, RS, name, u4, r, c, fv, rate, reps, checked, **extra):
    """The kernel's entry on inputs that resample_check compared (``checked``
    is what it returned): its time, its bound (the operations these inputs
    need when mesh 1 is tested only for the hits of mesh 2) and the share
    of it reached, beside them the bound of both meshes for every candidate
    (``bound_full_work_*``, the count earlier kernels were measured against),
    and the plain version's per-mesh hit shares."""
    err, h1, h2, _, n = checked
    ms = kernel_ms(torch, lambda: RS.sample_and_hit(u4, r, c, fv), reps, "resample_kernel")
    call_ms = cuda_ms(torch, lambda: RS.sample_and_hit(u4, r, c, fv), reps)
    plain_ms = cuda_ms(torch, lambda: RS.sample_and_hit_reference(u4, r, c, fv), 2, warmup=1)
    B = u4.shape[0] if u4.dim() == 3 else 1
    nbytes = n * 41 + B * (24 * 16 * 4 + 16)
    needed = RS.ops_needed(n, h2)
    (fb, _), (fbd, _) = bounds(n * RS.OPS_PER_CANDIDATE, nbytes, rate)
    e = entry(name, "a_robust_registration_loss_tpu_torch/csrc/resample.cu",
              "a_robust_registration_loss_tpu/ops/pallas/resample.py:43", err, ms, call_ms,
              plain_ms, needed, nbytes, rate, hit_share_mesh1=h1 / n,
              hit_share_mesh2=h2 / n, ops_needed=needed, ops_full_work=n * RS.OPS_PER_CANDIDATE,
              bound_full_work_ms=fbd, bound_full_work_ms_measured_rate=fb, **extra)
    nb = e["bound_ms_measured_rate"]
    e.update(share_of_bound_measured_rate=nb / ms,
             share_of_full_work_bound_measured_rate=fb / ms)
    print(f"{name} ({extra.get('shape', f'C={n}')}): kernel {ms:.4f} ms, call {call_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms; mesh 1 hit by {h1 / n:.4f}, mesh 2 by {h2 / n:.4f}; bound "
          f"{nb:.5f} ms at the measured rate for the work these inputs need ({nb / ms:.1%} of "
          f"it reached), {fb:.5f} ms for both meshes on every candidate ({fb / ms:.1%})",
          flush=True)
    return e


def resample_phase(torch, G, RS, data, gen, rate):
    """The resampler at the classical path's width and at C = 777, exact,
    then on the adversarial sets; its entry on the C = 200,000 draw that
    was compared."""
    fv = RS.prep_faces(G.bbox_face_vertices(data["src"][None])[0],
                       G.bbox_face_vertices(data["tar"][None])[0])
    r, c = data["radius"], data["center"]
    drawn = {}
    for C in (10 * N_LINES, 777):
        u4 = torch.rand((4, C), generator=gen, device=DEV)
        drawn[C] = u4, resample_check(torch, RS, u4, r, c, fv, f"C={C}")
        _, h1, h2, acc, n = drawn[C][1]
        print(f"resample C={C}: cand and ok equal the plain version bit for bit; mesh 1 hit "
              f"by {h1 / n:.5f}, mesh 2 by {h2 / n:.5f}, accepted {acc / n:.5f}", flush=True)
    resample_adversarial(torch, RS)
    u4, checked = drawn[10 * N_LINES]
    return resample_entry(torch, RS, "resample_sample_and_hit", u4, r, c, fv, rate, 50, checked)


def profile_phase(torch, one, n, what, ms_per, units=1, strict=True):
    """Where the time of ``n`` calls of ``one`` goes, under torch.profiler;
    a call covers ``units`` steps, iterations or batches (``what``). Prints
    the kernels, the device time and its share of the unprofiled ``ms_per``,
    all per unit, and the costliest device operations. Fails if a call
    copies between host and device or waits for the device, unless not
    ``strict``: then it counts them."""
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
    n = n * units
    plural = what + ("es" if what.endswith("ch") else "s")
    busy = sum(t for t, _ in by_name.values()) / 1e3 / n
    if not by_name:
        print("profile: no device activity recorded; device time not measured",
              flush=True)
    else:
        print(f"profile over {n} {plural}: {kernels / n:.1f} kernels/{what}, "
              f"device time {busy:.4f} ms/{what} = {busy / ms_per:.1%} of "
              f"{ms_per:.4f} ms/{what}; host<->device copies {copies}; sync calls "
              f"{syncs}", flush=True)
        for name, (tot, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"  {tot / 1e3 / n:9.4f} ms/{what} {calls / n:6.1f}/{what}  "
                  f"{name[:90]}", flush=True)
    if strict:
        check(copies == 0, f"{copies} host<->device copies in {n} {plural}")
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


GATHER_SRC = "a_robust_registration_loss_tpu_torch/csrc/gather.cu"


def gather_check(torch, GK, table, idx, g, what):
    """Forward and backward kernels on (table, idx, g) against their plain
    versions: forward bit for bit; the backward's sort equal to its plain
    version; backward equal to the plain version on
    the CPU bit for bit, within 1e-6 x sum_q |g| of the plain version on
    the card, two launches and the autograd path equal bit for bit.
    Returns the largest |kernel - plain on the card| of the forward and of
    the backward."""
    N = table.shape[1]
    out = GK.gather_rows_fwd(table, idx)
    plain = GK.gather_rows_reference(table, idx)
    check(torch.equal(out, plain), f"gather {what}: forward differs from the plain version")
    inside = (idx >= 0) & (idx < N)
    if bool(inside.all()):
        check(torch.equal(out, torch.take_along_dim(table, idx.long()[..., None], 1)),
              f"gather {what}: forward differs from take_along_dim")
    else:
        check(bool((out[~inside] == 0).all()), f"gather {what}: an out-of-range row is not zero")
    start, perm = GK.sort_by_row(idx, N)
    want_start, want_perm = GK.sort_by_row_reference(idx, N)
    check(torch.equal(start, want_start) and torch.equal(perm, want_perm),
          f"gather {what}: the backward's sort differs from the plain version")
    d1, d2 = GK.gather_rows_bwd(g, idx, N), GK.gather_rows_bwd(g, idx, N)
    check(torch.equal(d1, d2), f"gather {what}: two backward launches differ")
    check(torch.equal(d1, GK.segmented_sum(g, start, perm)),
          f"gather {what}: the backward differs from its sum on the checked sort")
    ref_cpu = GK.gather_rows_bwd_reference(g.cpu(), idx.cpu(), N)
    check(torch.equal(d1.cpu(), ref_cpu),
          f"gather {what}: backward differs from the plain version on the CPU")
    ref = GK.gather_rows_bwd_reference(g, idx, N)
    tol = 1e-6 * GK.gather_rows_bwd_reference(g.abs(), idx, N)
    check(bool(((d1 - ref).abs() <= tol).all()),
          f"gather {what}: backward beyond 1e-6 x sum |g| of the plain version on the card")
    leaf = table.detach().requires_grad_(True)
    (d3,) = torch.autograd.grad(GK.gather_rows(leaf, idx), leaf, g)
    check(torch.equal(d3, d1), f"gather {what}: autograd's backward differs from the kernel's")
    return float((out - plain).abs().max()), float((d1 - ref).abs().max())


def gather_times(torch, GK, table, idx, g):
    """Times and bounds of both directions on these inputs: {"fwd": fields,
    "bwd": fields}. The backward's time is the device time of all of its
    kernels together, with the split by kernel beside it. The bound is
    bytes: values and indices read once, the result written once. The
    backward's library call is ``index_add_`` alone, onto a buffer zeroed
    once before the timed calls (the kernels write every element and need
    no memset)."""
    (B, N, C), Q = table.shape, idx.shape[1]
    nbytes = 4 * (B * N * C + B * Q * C) + idx.element_size() * B * Q
    flat = (idx.long() + torch.arange(B, device=idx.device)[:, None] * N).reshape(-1)
    long_idx = idx.long()[..., None]
    into = torch.zeros((B * N, C), device=table.device)
    calls = {
        "fwd": (lambda: GK.gather_rows_fwd(table, idx), "gather_fwd_",
                lambda: GK.gather_rows_reference(table, idx),
                lambda: torch.take_along_dim(table, long_idx, 1)),
        "bwd": (lambda: GK.gather_rows_bwd(g, idx, N), "gather_bwd_",
                lambda: GK.gather_rows_bwd_reference(g, idx, N),
                lambda: into.index_add_(0, flat, g.reshape(B * Q, C))),
    }
    out = {}
    for name, (call, kernel, plain, library) in calls.items():
        split = dict(GATHER_BWD_KERNELS) if name == "bwd" else None
        ms = kernel_ms(torch, call, 20, kernel, per_call=len(split) if split else 1, split=split)
        out[name] = dict(ms=ms, call_ms=cuda_ms(torch, call, 20),
                         plain_ms=cuda_ms(torch, plain, 5, warmup=1),
                         library_ms=kernel_ms(torch, library, 20), ops=0, nbytes=nbytes,
                         shape=f"B={B} N={N} C={C} Q={Q} idx {str(idx.dtype)[6:]}")
        if split:
            out[name].update(kernels_per_call=len(split), ms_by_kernel=split)
    return out


def split_text(m):
    """' (hist a + place b + sum c)' of a backward's fields, '' of a forward's."""
    if "ms_by_kernel" not in m:
        return ""
    return " (" + " + ".join(f"{k} {v:.4f}" for k, v in m["ms_by_kernel"].items()) + ")"


def gather_phase(torch, GK, rate):
    """The gather kernels at ``GATHER_SHAPES``, random inputs from seed 4,
    int32 indices (int64 too at the ragged shape). Returns {shape name:
    {"fwd": fields, "bwd": fields}} of the two large shapes, each with
    ``err``, its shape's largest |kernel - plain on the card|."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4)
    times = {}
    for name, (B, N, C, Q) in GATHER_SHAPES.items():
        table = torch.randn((B, N, C), generator=gen, device=DEV)
        g = torch.randn((B, Q, C), generator=gen, device=DEV)
        lo, hi = (-3, N + 3) if name == "ragged" else (0, N)
        idx = torch.randint(lo, hi, (B, Q), generator=gen, device=DEV, dtype=torch.int32)
        errs = [gather_check(torch, GK, table, idx, g, name)]
        if name == "ragged":
            errs.append(gather_check(torch, GK, table, idx.long(), g, name + " int64"))
        ef, eb = (max(e) for e in zip(*errs))
        print(f"gather {name} (B={B} N={N} C={C} Q={Q}): forward equals the plain version "
              "bit for bit; backward equals the plain version on the CPU bit for bit, "
              f"max |kernel - plain on the card| {eb:.3g}, two launches equal", flush=True)
        if name != "ragged":
            times[name] = gather_times(torch, GK, table, idx, g)
            times[name]["fwd"]["err"], times[name]["bwd"]["err"] = ef, eb
            for k, m in times[name].items():
                (_, _), (db, _) = bounds(0, m["nbytes"], rate)
                print(f"  gather_{k} {m['shape']}: kernel {m['ms']:.4f} ms{split_text(m)}, call "
                      f"{m['call_ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, library call "
                      f"{m['library_ms']:.4f} ms, bound {db:.5f} ms by bytes "
                      f"({db / m['ms']:.1%} of it reached)", flush=True)
    for name, (B, N, C, Q) in GATHER_EDGES.items():
        table = torch.randn((B, N, C), generator=gen, device=DEV)
        g = torch.randn((B, Q, C), generator=gen, device=DEV)
        if name == "one_row":
            idx = torch.full((B, Q), N // 3, device=DEV, dtype=torch.int32)
        elif name == "sparse_rows":
            rows = torch.tensor([3, 700, 701, 1500, N - 1], device=DEV, dtype=torch.int32)
            idx = rows[torch.randint(0, 5, (B, Q), generator=gen, device=DEV)]
        elif name == "out_of_range":
            idx = torch.randint(-N // 4, N + N // 4, (B, Q), generator=gen, device=DEV,
                                dtype=torch.int32)
        else:
            idx = torch.where(torch.rand((B, Q), generator=gen, device=DEV) < 0.5, -1, N).int()
        empty = 1 - torch.unique(idx[(idx >= 0) & (idx < N)]).numel() / N
        for ix in (idx, idx.long()):
            gather_check(torch, GK, table, ix, g, f"{name} {str(ix.dtype)[6:]}")
        print(f"gather edge case {name} (B={B} N={N} C={C} Q={Q}, {empty:.1%} of the rows "
              "without a query, int32 and int64): sort, forward and backward equal their "
              "plain versions", flush=True)
    return times


def resample_batch_phase(torch, G, RS, batch, rate):
    """One batched launch at B = 4 and 150,000 candidates per sample equals
    4 single launches and the plain version bit for bit; its time and
    bounds."""
    C = 10 * L3
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    u4 = torch.rand((B3, 4, C), generator=gen, device=DEV)
    # the arguments batch_lines gives the kernel for this batch
    box, c = batch["tar_box"], batch["centers"]
    r = 0.5 * torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
    fv = RS.prep_faces(G.bbox_face_vertices(batch["points_src_sample"]),
                       G.bbox_face_vertices(batch["points_tar_sample"]))
    before = RS.launches.copy()
    cand, ok = RS.sample_and_hit(u4, r, c, fv)
    check(RS.launches - before == {"batched": 1},
          "the batched resampler call is not one batched launch")
    for b in range(B3):
        cand_b, ok_b = RS.sample_and_hit(u4[b], r[b], c[b], fv[b])
        check(torch.equal(cand[b], cand_b) and torch.equal(ok[b], ok_b),
              f"resampler: sample {b} of the batched launch differs from its single launch")
    checked = resample_check(torch, RS, u4, r, c, fv, f"batched B={B3} C={C}")
    _, h1, h2, acc, n = checked
    print(f"resample batched B={B3} C={C}: one launch equals {B3} single launches and the "
          f"plain version bit for bit; mesh 1 hit by {h1 / n:.5f}, mesh 2 by {h2 / n:.5f}, "
          f"accepted {acc / n:.5f}", flush=True)
    return resample_entry(torch, RS, "resample_batched", u4, r, c, fv, rate, 20, checked,
                          shape=f"B={B3} C={C}")


def dcp_batches(torch, G):
    """``BATCHES3`` batches of ``B3`` pairs in the dataset dict's DCP form
    (column convention R), made on the card with the port's own functions
    from seed 0: noisy Fibonacci unit spheres, a rotation about z (0.25 rad
    plus 0.02 per batch) and a translation, both clouds centred, FPS + 3-NN
    neighbourhood buffers (B, F * 3, 3), the target's bbox corners."""
    rng = np.random.default_rng(0)
    i = np.arange(N3) + 0.5
    phi = np.arccos(1 - 2 * i / N3)
    th = np.pi * (1 + 5**0.5) * i
    base = np.stack([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th), np.cos(phi)], -1)
    n = BATCHES3 * B3
    src = (base + rng.standard_normal((n, N3, 3)) * 0.01).astype(np.float32)
    ang = 0.25 + 0.02 * (np.arange(n) // B3)
    R = np.zeros((n, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = (
        np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang), 1.0)
    T = np.tile(np.asarray([0.05, -0.02, 0.01], np.float32), (n, 1))
    tar = src @ R + T[:, None]
    tar = tar - tar.mean(1, keepdims=True)
    src = src - src.mean(1, keepdims=True)
    src, tar = torch.tensor(src, device=DEV), torch.tensor(tar, device=DEV)
    R, T = torch.tensor(R, device=DEV), torch.tensor(T, device=DEV)
    data = {
        "points_src_sample": src, "points_tar_sample": tar,
        "points_based_neighs_src": G.sample_neighs(src, F3, 3),
        "points_based_neighs_tar": G.sample_neighs(tar, F3, 3),
        "tar_box": G.bounding_box_corners(tar), "centers": tar.mean(1),
        # column convention: tar = R^T src + T before the centring
        "R": R.transpose(-1, -2).contiguous(), "T": T,
        "R_inv": R, "T_inv": -torch.einsum("bij,bj->bi", R, T),
    }
    return [{k: v[j * B3:(j + 1) * B3] for k, v in data.items()} for j in range(BATCHES3)]


def dcp_model(torch, D, TD, LS):
    """The DCP path's configuration and its model at the defaults' width on
    the card, weights from seed 0: (cfg, model)."""
    cfg = TD.DCPTrainConfig(loss=LS.LossConfig(n_lines=L3), model=D.DCPConfig())
    model = D.DCP(cfg.model)
    D.reset_parameters(model, torch.Generator().manual_seed(0))
    return cfg, model.to(DEV)


def dcp_path(torch, mods, cfg, model, batches):
    """DCP's evaluation path at full width (see the module docstring, phase
    10): ``evaluate`` over the batches, then the forward and gradient of
    ``dcp_train_loss``. Returns the launches of each, counted in a run of
    its own: (evaluate, gradient)."""
    import tempfile

    G, M, IK, RS, PB, LS, GK, D, TD = mods
    n_params = sum(p.numel() for p in model.parameters())
    sd = model.state_dict()
    quiet = lambda msg: None

    # evaluate over the 8 batches, OBJ dumps and Eval.json included
    with tempfile.TemporaryDirectory() as tmp:
        TD.evaluate(cfg, sd, batches[:1], tmp, log=quiet, save_objs=False)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts(IK, RS, PB, reset=True)
        t0 = time.perf_counter()
        summary = TD.evaluate(cfg, sd, batches, tmp, log=quiet, epoch=1)
        torch.cuda.synchronize()
        ms_eval = 1e3 * (time.perf_counter() - t0) / BATCHES3
        eval_launches = counts(IK, RS, PB)
        with open(os.path.join(tmp, "Eval.json")) as f:
            check(json.load(f) == summary, "Eval.json differs from the returned summary")
        objs = [f for f in os.listdir(tmp) if f.endswith(".obj")]
        check(len(objs) == 4 * B3 * BATCHES3, f"{len(objs)} OBJ files written")
        check_counts(eval_launches, {"resample_batched": 1, "stage1_pair_pts": 1}, BATCHES3,
                     "DCP evaluate")
        check(all(np.isfinite(v) for v in summary.values()), f"a metric is not finite: {summary}")
        check(summary["loss_intersection"] > 0, "no usable line in the evaluation")
        print(f"DCP evaluate: {BATCHES3} batches of B={B3} N={N3} F={F3} L={L3}, "
              f"{n_params / 1e6:.2f} M parameters: {ms_eval:.4f} ms/batch (set-up, OBJ dumps "
              f"and Eval.json included); loss_intersection {summary['loss_intersection']:.6f}, "
              f"loss_chamfer {summary['loss_chamfer']:.6f}, r_rmse_ab {summary['r_rmse_ab']:.4f} "
              f"deg, t_rmse_ab {summary['t_rmse_ab']:.6f}; launches {eval_launches}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
        t0 = time.perf_counter()
        TD.evaluate(cfg, sd, batches, tmp, log=quiet, save_objs=False)
        torch.cuda.synchronize()
        ms_eval_bare = 1e3 * (time.perf_counter() - t0) / BATCHES3
        print(f"DCP evaluate without the OBJ dumps: {ms_eval_bare:.4f} ms/batch", flush=True)
        profile_phase(torch, lambda: TD.evaluate(cfg, sd, batches[:PROFILED3], tmp, log=quiet,
                                                 save_objs=False),
                      1, "batch", ms_eval_bare, units=PROFILED3, strict=False)

    # forward and gradient of dcp_train_loss through the network
    params = list(model.parameters())
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)

    def iteration(batch):
        out = TD.forward(model, batch)
        loss, _ = LS.dcp_train_loss(batch, *out, cfg.loss, generator=gen)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), torch.stack([torch.isfinite(g).all() for g in grads]).all()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts(IK, RS, PB, reset=True)
    results = []
    for it in range(GRAD_ITERS3):
        if it == WARMUP2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        results.append(iteration(batches[it % BATCHES3]))
    torch.cuda.synchronize()
    ms_grad = 1e3 * (time.perf_counter() - t0) / (GRAD_ITERS3 - WARMUP2)
    grad_launches = counts(IK, RS, PB)
    check_counts(grad_launches, {"resample_batched": 1, "stage1_pair_pts": 1}, GRAD_ITERS3,
                 "DCP forward + gradient")
    losses = torch.stack([r[0] for r in results]).cpu().numpy()
    # the cross-covariances the SVD head took, read on one more forward per
    # batch outside the timed and counted iterations
    seen = []
    hook = model.head.register_forward_hook(
        lambda mod, args, out: seen.append(torch.linalg.svdvals(mod.correlation(*args)[0])))
    with torch.no_grad():
        for batch in batches:
            TD.forward(model, batch)
    hook.remove()
    sv = torch.stack(seen).cpu().numpy()  # (batches, B, 3), descending
    check(bool(torch.stack([r[1] for r in results]).all()), "a parameter's gradient is not finite")
    check(np.isfinite(losses).all() and (losses > 0).all(), f"losses {losses}")
    gap = np.minimum(sv[..., 0] - sv[..., 1], sv[..., 1] - sv[..., 2]) / sv[..., 0]
    check(np.isfinite(sv).all() and gap.min() > 1e-4 and (sv[..., 2] / sv[..., 0]).min() > 1e-4,
          f"the SVD head's input is degenerate: singular values {sv.reshape(-1, 3)}")
    print(f"DCP forward + gradient: {GRAD_ITERS3} iterations, {ms_grad:.4f} ms/iteration over "
          f"the last {GRAD_ITERS3 - WARMUP2}; loss {losses[0]:.6f} .. {losses[-1]:.6f}; every "
          f"gradient finite; H's singular values {sv.min(axis=(0, 1))} to {sv.max(axis=(0, 1))}, "
          f"least relative gap {gap.min():.4f}; launches {grad_launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    state = {"it": 0}

    def one():
        iteration(batches[state["it"] % BATCHES3])
        state["it"] += 1

    profile_phase(torch, one, PROFILED3, "iteration", ms_grad, strict=False)

    return eval_launches, grad_launches


def dcp_kernels_phase(torch, mods, cfg, model, batch, rate):
    """The kernels at the shapes and on the data the DCP path gives them
    (see the module docstring, phase 9), before the paths' long profiles:
    after those the tracer loses the records of short kernels. Returns the
    launches of the ``graph_gather``, counted in a run of its own, the
    ``gather`` kernels' fields on the graph's indices and ``stage1``'s
    fields at this path's shape."""
    G, M, IK, RS, PB, LS, GK, D, TD = mods
    sd = model.state_dict()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(6)

    # the gather kernels on the model's own graph: the kNN indices of the
    # first DGCNN stage and the gradient that reaches the gathered features
    x = batch["points_src_sample"]
    k = cfg.model.dgcnn_k
    idx = D.knn_graph_indices(x, k).reshape(B3, N3 * k)
    edge = D.knn_graph_feature(x, k).detach().requires_grad_(True)
    (up,) = torch.autograd.grad(model.emb_nn.embed_graph(edge).square().mean(), edge)
    up = up[..., :3].reshape(B3, N3 * k, 3).contiguous()
    counts(IK, RS, PB, reset=True)
    table = x.detach().clone().requires_grad_(True)
    got = GK.gather_rows(table, idx)
    (d_table,) = torch.autograd.grad(got, table, up)
    gather_launches = counts(IK, RS, PB)
    check_counts(gather_launches, {"gather_fwd": 1, "gather_bwd": 1}, 1, "graph gather")
    check(GK.BWD_KERNELS == len(GATHER_BWD_KERNELS), "the backward's kernels are not those timed")
    check(torch.equal(got.detach(), edge[..., :3].reshape(B3, N3 * k, 3)),
          "gather_rows on the graph's indices differs from the features the model gathered")
    check(torch.equal(d_table.cpu(), GK.gather_rows_bwd_reference(up.cpu(), idx.cpu(), N3)),
          "gather_rows' backward of the model's upstream gradient differs from the plain "
          "version on the CPU")
    ef, eb = gather_check(torch, GK, x, idx, up, "DCP graph")
    times = gather_times(torch, GK, x, idx, up)
    times["fwd"]["err"], times["bwd"]["err"] = ef, eb
    print(f"gather on DCP's graph (B={B3} N={N3} k={k}: Q={N3 * k}, C=3, int64 indices): "
          "forward equals the model's gathered features bit for bit; backward of the model's "
          f"upstream gradient equals the plain version's (CPU: bit for bit; card: {eb:.3g})",
          flush=True)

    # the card against the CPU's plain path at the path's own width: the
    # network's (R_ab, t_ab); stage 1 as dcp_cal_loss launches it (both
    # clouds, pts mode, B x F x L of the path) against its plain version on
    # the card; then counts and loss on the same lines against the CPU
    cpu_model = D.DCP(cfg.model)
    cpu_model.load_state_dict({key: v.cpu() for key, v in sd.items()})
    cpu_batch = {key: v.cpu() for key, v in batch.items()}
    with torch.no_grad():
        R_k, t_k = TD.forward(model, batch)[:2]
        R_c, t_c = TD.forward(cpu_model, cpu_batch)[:2]
        rerr = float((R_k.cpu() - R_c).abs().max())
        terr = float((t_k.cpu() - t_c).abs().max())
        u4 = LS.draw_uniforms(B3, L3, DEV, gen)
        lines = LS.batch_lines(u4, batch["tar_box"], batch["centers"], L3,
                               LS.dcp_transform(x, R_k, t_k), batch["points_tar_sample"], 0.5)
        R_row = R_k.transpose(-1, -2)
        n1, n2 = (LS._flat_neis(batch[key]) for key in
                  ("points_based_neighs_src", "points_based_neighs_tar"))
        # the transformed source neighbourhoods, as rigid_slots forms them
        n1_t = (n1.reshape(B3, -1, 3) @ R_row + t_k[:, None, :]).reshape(n1.shape)
        deltas = (M.neighborhood_delta(n1_t), M.neighborhood_delta(n2))
        got = IK.stage1((n1_t, n2), lines, deltas, cfg.loss.kmax, **PTS)
        ref = IK.stage1_reference((n1_t, n2), lines, deltas, cfg.loss.kmax, **PTS)
        for g, r, what in zip(got, ref, ("count", "slot_idx", "d2", "recon", "slot_pts")):
            check((g is None and r is None) or torch.equal(g, r),
                  f"stage1 at the DCP path's shape: {what} differs from the plain version")
        s1_err = float((got[4] - ref[4]).abs().max())
        print(f"stage1 at the DCP path's shape: B={B3} F=({n1.shape[1]}, {n2.shape[1]}) L={L3} "
              f"hits={int(got[0].sum())} max count={int(got[0].max())}: count, slot_idx, "
              "slot_pts equal the plain version bit for bit", flush=True)

        def call():
            return IK.stage1((n1_t, n2), lines, deltas, cfg.loss.kmax, **PTS)

        F, kk = n1.shape[1] + n2.shape[1], cfg.loss.kmax
        stage1 = dict(
            err=s1_err, ms=kernel_ms(torch, call, 20, "stage1_kernel"),
            call_ms=cuda_ms(torch, call, 20),
            plain_ms=cuda_ms(torch, lambda: IK.stage1_reference(
                (n1_t, n2), lines, deltas, cfg.loss.kmax, **PTS), 1, warmup=1),
            ops=B3 * L3 * F * IK.OPS_PER_PAIR,
            nbytes=B3 * (L3 * 24 + F * 40 + 2 * L3 * (4 + 4 * kk + 36 * kk)),
            shape=f"B={B3} clouds=2 F={n1.shape[1]} L={L3}")
        out = {}
        t0 = time.perf_counter()
        for dev, b in ((DEV, batch), ("cpu", cpu_batch)):
            args = (R_row.to(dev), t_k.to(dev), LS._flat_neis(b["points_based_neighs_src"]),
                    LS._flat_neis(b["points_based_neighs_tar"]), lines.to(dev))
            c1, c2 = M.rigid_slots(*args, cfg.loss.kmax)[2:]
            per = LS._metric_batch_rt(*args, cfg.loss) / 5.0
            out[dev] = (c1.cpu(), c2.cpu(), float(per.sum() / B3))
    (c1k, c2k, lk), (c1c, c2c, lc) = out[DEV], out["cpu"]
    print(f"DCP on the card vs the CPU's plain path: max |R_ab| diff {rerr:.3g}, |t_ab| "
          f"diff {terr:.3g}; at L={L3} on the same lines stage-1 counts equal: "
          f"{torch.equal(c1k, c1c) and torch.equal(c2k, c2c)} ({int(c1k.sum())} and "
          f"{int(c2k.sum())} hits), loss {lk:.7f} vs {lc:.7f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(rerr <= 1e-4 and terr <= 1e-4, f"R_ab off by {rerr}, t_ab by {terr}")
    check(torch.equal(c1k, c1c) and torch.equal(c2k, c2c) and int(c1k.sum()) > 0,
          "DCP parity: stage-1 counts differ from the CPU's")
    check(abs(lk - lc) <= 1e-4 * abs(lc), f"DCP loss {lk} vs the CPU's {lc}")
    return dict(graph_gather=gather_launches, gather=times, stage1=stage1)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from a_robust_registration_loss_tpu_torch.models import dcp as D
    from a_robust_registration_loss_tpu_torch.ops import geometry as G
    from a_robust_registration_loss_tpu_torch.ops import lines as LN
    from a_robust_registration_loss_tpu_torch.ops import metric as M
    from a_robust_registration_loss_tpu_torch.ops.cuda import _build
    from a_robust_registration_loss_tpu_torch.ops.cuda import gather as GK
    from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
    from a_robust_registration_loss_tpu_torch.ops.cuda import probe as PB
    from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
    from a_robust_registration_loss_tpu_torch.se3 import se3
    from a_robust_registration_loss_tpu_torch.train import classical
    from a_robust_registration_loss_tpu_torch.train import dcp as TD
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
    stage1_segments_phase(torch, M, IK, n1, n2, lines2)
    gather = gather_phase(torch, GK, rate)
    t0 = time.perf_counter()
    batches3 = dcp_batches(torch, G)
    torch.cuda.synchronize()
    print(f"DCP data: {BATCHES3} batches of B={B3} N={N3} F={F3}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    resample_batched = resample_batch_phase(torch, G, RS, batches3[0], rate)
    mods3 = (G, M, IK, RS, PB, LS, GK, D, TD)
    cfg3, model3 = dcp_model(torch, D, TD, LS)
    dcp = dcp_kernels_phase(torch, mods3, cfg3, model3, batches3[0], rate)
    src = "a_robust_registration_loss_tpu_torch/csrc/intersect.cu"
    kernels = [pts] + [
        entry(name, src, "a_robust_registration_loss_tpu/ops/pallas/intersect.py:56",
              m["err"], m["ms"], m["call_ms"], m["plain_ms"], m["ops"], m["nbytes"], rate,
              shape=m["shape"])
        for name, m in modes.items() if name != "stage1_pair_pts"] + [
            resample, resample_batched, probe]
    p2 = modes["stage1_pair_pts"]
    (mb, _), (db, _) = bounds(p2["ops"], p2["nbytes"], rate)
    pts.update(config2_shape=p2["shape"], config2_ms=p2["ms"],
               config2_call_ms=p2["call_ms"], config2_plain_ms=p2["plain_ms"], config2_bound_ms=db,
               config2_bound_ms_measured_rate=mb,
               max_abs_err=max(pts["max_abs_err"], p2["err"]))
    p3 = dcp["stage1"]
    (mb, _), (db, _) = bounds(p3["ops"], p3["nbytes"], rate)
    pts.update(dcp_shape=p3["shape"], dcp_ms=p3["ms"],
               dcp_call_ms=p3["call_ms"], dcp_plain_ms=p3["plain_ms"], dcp_bound_ms=db,
               dcp_bound_ms_measured_rate=mb,
               max_abs_err=max(pts["max_abs_err"], p3["err"]))
    print(f"stage1_pair_pts at the DCP path's shape ({p3['shape']}): kernel {p3['ms']:.4f} ms, "
          f"call {p3['call_ms']:.4f} ms, plain {p3['plain_ms']:.3f} ms, bound {mb:.5f} ms at "
          f"the measured rate ({mb / p3['ms']:.1%} of it reached), {db:.5f} ms at the data "
          "sheet's", flush=True)
    # the gather's entries: its error and times on the DCP graph's indices,
    # the shape its path gives it, and beside them those at the two recorded
    # shapes
    for name, line in (("fwd", 47), ("bwd", 58)):
        m = dcp["gather"][name]
        e = entry(f"gather_{name}", GATHER_SRC,
                  f"a_robust_registration_loss_tpu/ops/pallas/gather.py:{line}",
                  m["err"], m["ms"], m["call_ms"], m["plain_ms"],
                  0, m["nbytes"], rate, library_ms=m["library_ms"], shape=m["shape"])
        e["by_shape"] = {
            shape: dict(shape=t[name]["shape"], max_abs_err=t[name]["err"], ms=t[name]["ms"],
                        call_ms=t[name]["call_ms"],
                        plain_ms=t[name]["plain_ms"], library_ms=t[name]["library_ms"],
                        bound_ms=bounds(0, t[name]["nbytes"], rate)[1][0], bound_by="bytes")
            for shape, t in gather.items()}
        kernels.append(e)
        for key in ("kernels_per_call", "ms_by_kernel"):
            if key in m:
                e[key] = m[key]
                for shape, t in gather.items():
                    e["by_shape"][shape][key] = t[name][key]
        print(f"{e['name']} on DCP's graph ({e['shape']}): kernel {e['ms']:.4f} "
              f"ms{split_text(m)}, call "
              f"{e['call_ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library call "
              f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.5f} ms by bytes "
              f"({e['bound_ms'] / e['ms']:.1%} of it reached)", flush=True)
    for k in kernels:
        print(f"{k['name']}: kernel {k['ms']:.4f} ms, wrapper call {k['call_ms']:.4f} ms "
              f"back to back (plain {k['plain_ms']:.3f} ms), bound "
              f"{k['bound_ms_measured_rate']:.5f} ms by {k['bound_by_measured_rate']} at the "
              f"measured rate ({k['bound_ms_measured_rate'] / k['ms']:.1%} of it reached), "
              f"{k['bound_ms']:.5f} ms by {k['bound_by']} at the data sheet's", flush=True)

    classical_launches = main_path(torch, classical, se3, G, M, IK, RS, PB, LN, data, cfg)
    objective, mix = batch_path(torch, M, IK, RS, PB, LS, se3, src2, n1, n2, lines2)
    dcp_eval, dcp_grad = dcp_path(torch, mods3, cfg3, model3, batches3)
    paths = {"probe": {"probe_fp32_rate": probe_launches}, "classical": classical_launches,
             "bench_loss_objective": objective, "batched_metric": mix,
             "dcp_evaluate": dcp_eval, "dcp_forward_gradient": dcp_grad,
             "dcp_graph_gather": dcp["graph_gather"]}
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
