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
- DCP's evaluation path and its training at ``DCPConfig``'s defaults (DGCNN
  with k = 20, one transformer block of 4 heads and ff 1,024, the SVD head,
  512 embedding dimensions, weights from seed 0): 8 batches of 4 synthetic
  pairs of a 1,024-point noisy Fibonacci sphere from seed 0, 1,024 FPS + 3-NN
  neighbourhoods per cloud, 15,000 lines per sample;
- the batched classical step and the demo at ``bench.py``'s widths, 4
  pairs; the classical runner's CUDA graphs at both widths against its
  eager loop;
- the data layer, FMR and DCP's CLI on a dataset written from files: six
  synthetic base clouds of 4,096 points from seed 0 (three bare noisy
  Fibonacci ellipsoids, three triangulated latitude-longitude ellipsoids),
  10 views each at the FMR convergence protocol's widths
  (``benchmarks/train_convergence.py:37-52``: 1,024 points, F = 1,024,
  45 degrees, 0.3), 48 training and 12 test pairs; FMR at ``FMRConfig``'s
  full width (dim_k 1,024, 2.65 M parameters from seed 0; B = 4, 15,000
  lines, train maxiter 5, eval maxiter 10, lr 1e-6), DCP's CLI at its
  defaults (PointNet, transformer, SVD head, emb 512), and RPM-Net at
  ``RPMNetConfig``'s full width (features ppf, dxyz, xyz; feat_dim 96;
  radius 0.3 and 64 neighbours; 5 Sinkhorn iterations with slack; the
  annealing PointNet; 2 registration iterations in training and 5 in
  evaluation; B = 4, 10,000 lines; identity pretraining cut from the
  convergence protocol's 20 epochs to 1).

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
   failing on them;
11. the batched classical path: 4 pairs in ``bench.py``'s shape (pair s a
   4,096-point Fibonacci ellipsoid with 0.01 noise made from seed s, its
   target the ellipsoid noised again and moved by a known small rigid
   motion, ``planted_motion(s)``), ``prepare_pairs`` at F = 2,048, then
   ``make_batch_step`` for 10 warm-up and 50 timed epochs at 20,000 lines a
   pair, one batched resampler and one stage-1 launch an epoch for all 4
   pairs, a 10-epoch profile that fails on a host copy or wait, and one
   batched epoch against 4 single ``update``s on the same lines and twists
   (losses within 1e-5 relative, twists within 1e-5); it prints
   pair-iterations/s beside the single step's it/s of phase 5;
12. the demo through its ``cli``, the 4 pairs written as OBJ files twice:
   noisy as in phase 11, then each target an exact rigid copy of its
   source. Each set runs once single (label 0) and once batched
   (``--labels 0,1,2,3``), 200 epochs each with ``--log_every 20`` at the
   demo's default widths; every expected file written
   (``registration.png`` where matplotlib imports), one launch of each
   kernel an epoch. Noisy pairs: each pair's last chamfer below its first
   and its last transform within 0.05 rad and 0.05 of the planted motion.
   Exact copies: each pair's chamfer down to 1e-6 in some epoch and, single,
   a logged transform within 0.005 rad and 0.005 of the planted motion; a
   pair that leaves the motion afterwards is printed with its epoch (the
   metric's lower median collapses on noise-free copies and Adam's steps
   carry the twist off, on the plain path and in the JAX package's
   arithmetic too: ``tools/exact_copy_drift.py``). The demo prints its own
   iters/sec and pair-iters/sec lines;
13. DCP's training at the DCP path's width on its 8 batches: ``train`` for
   1 pretrain and 2 epochs with 4 test batches, checkpoints every epoch and
   artifacts; the state a resume loads equal to the state saved bit for bit
   (every parameter, both moments, the count); the resume to 3 epochs, and
   an uninterrupted 3-epoch run whose train loss is within 1e-5 relative of
   the first run's in epochs 0 and 1 and of the resumed run's in epoch 2;
   every metric finite; a NaN batch skipped with the model and the
   optimiser state unchanged bit for bit, and ``guarded_update`` on the
   card skipping one NaN or inf among the 5.57 M gradient entries; then
   ``train_step``'s ms/iteration and a 5-iteration profile that counts host
   copies and waits (the SVD head waits), and ``guarded_update``'s kernels,
   in a profile that fails on a host copy or wait;
14. (run first, after the build, with the first part of phase 17) the
   data layer: ``estimate_normals`` of 4,096 points
   timed on the card,
   ``make_dataset.main`` writing the 60 pairs (views layout) with its wall
   time and no kernel launched, the objio backend (``native``);
   ``generate_datasets`` giving 12 training batches of 4 and 12 test
   batches, and ``DeviceCache``'s batches equal to the streaming
   ``Loader``'s bit for bit over two epochs;
15. FMR through ``train.fmr.main`` on those files: 2 epochs (one batched
   resampler and 3 stage-1 launches a training step, none an eval step),
   the resume to 3 epochs and an uninterrupted 3-epoch run (every epoch's
   loss within 1e-5), the checkpoints, ``metrics.jsonl``'s
   ``time/epoch_seconds``; ``--eval_only`` (12 twist rows, a finite mean dm,
   ``eval_summary.json``, no launch) and ``--eval_only --add_noise``; the
   resampler and stage 1 on this path's own data against their plain
   versions bit for bit; the card against the CPU's plain path on one batch
   (the same lines: the solver's iterates within 5e-4; on the card's
   iterates, the loss within 1e-4 relative, its gradient to the iterates
   within 5e-4 relative L2 and equal stage-1 counts; end to end, the loss
   within 1e-4 and the gradient to every parameter within 5e-4);
   ``train_step`` fed from the ``DeviceCache`` with its ms/step and a
   5-step profile that fails on a host-to-device copy (the waits of
   ``svdvals`` are counted, and the solver's two library calls profiled
   alone); a NaN batch skipped with the state unchanged; a degenerate batch
   (both clouds on one line: the Jacobian is the target's) giving
   n_singular = B and g = I;
16. DCP's CLI on the same files: 1 epoch (one resampler and one stage-1
   launch a training step and an eval batch), ``--eval_only`` writing
   ``Eval.json``, ``--init_from_ckpt`` from that run (the parameters before
   the first step equal to the loaded ones) and ``--init_from_torch`` on a
   ``.pth`` of the first model's ``state_dict`` under a ``module.`` prefix
   inside ``{"state_dict": ...}`` with an integer beside it;
17. RPM-Net through ``train.rpmnet.main`` on those files: 1 pretraining
   and 2 training epochs, each step's launches checked by kind (a training
   step 1 batched resampler, 2 stage-1 ``<2,0,0,1>`` and 4 gather forwards;
   an eval step 10 gather forwards; a pretraining step 2; no gather
   backward and nothing else in any), the checkpoint equal to the trained
   state bit for bit (Adam's count and the schedule's apart), the resume to
   3 epochs and an uninterrupted 3-epoch run (every epoch's loss within
   1e-5); ``--eval_only`` (``Val.json``, each test pair's OBJ dumps and
   ``{epoch}_pred_src_{idx}.bin`` with R transposed, held to the
   checkpoint's model on the card), ``--init_from_ckpt`` and
   ``--init_from_torch`` on a reference-layout ``.pth`` (the annealing
   net's last layer with 2 + 3 outputs); (first, after phase 14) RPM-Net's
   ball query on a training batch, card against CPU (equal off the float64
   knife edge), and the gather on its indices against
   ``gather_rows_reference`` and ``take_along_dim`` bit for bit, with both
   directions' times; one training step on
   the card against the CPU's plain path with the card's lines and ball
   indices (loss within 1e-4 relative, equal stage-1 counts, the gradient
   within 5e-4 relative L2 or no farther from a float64 gradient than
   twice the CPU's, with the Kabsch covariances' singular values printed);
   ``train_step`` fed from the ``DeviceCache`` with its ms/step, peak
   memory and a 5-step profile that fails on a host-to-device copy (waits
   counted, Kabsch's ``svd`` and ``det`` profiled alone) and its
   GroupNorm passes timed alone at their shapes; a NaN batch skipped with
   the state unchanged;
18. each trainer in bf16 (``--dtype bfloat16``) at the width of its fp32
   phase (DCP at its CLI defaults, FMR as in phase 15, RPM-Net as in phase
   17): its CLI run with the fp32 run's flags, launches exact by kind of
   step as there, each epoch's train loss within 10% of the fp32 run's
   (DCP, RPM-Net; FMR's printed), the parameters fp32; the card's bf16
   forward against its fp32 forward on the same weights (the JAX package's
   ``TestMixedPrecision`` bars: DCP R and t within 0.05, RPM-Net's
   transforms 0.12, FMR's g 0.25 and ``loss_ende`` 10%, det R within
   1e-3 of 1, fp32 outputs); RPM-Net's resampler, stage 1 and gather on
   the bf16 step's own inputs against their plain versions bit for bit;
   the card's bf16 step against the CPU's bf16 step on the same weights,
   batch, lines and ball indices (``BF16_CPU``); ``train_step`` in each
   dtype from the same weights, side by side: ms/step, peak memory, a
   5-step profile (kernels, device time and share, host-to-device copies
   (must be 0), waits, the top kernels; RPM-Net's GroupNorm share from the
   trace); a NaN batch skipped with the state unchanged, and raising
   ``FloatingPointError`` under ``--debug_nans``;
19. RPM-Net's gather on its ball query timed again after every other
   phase (``late_gather_phase``): every launch seen in a window;
20. (run after phase 18) data and line parallelism on the one card
   (``sharded_phase``), its ranks over gloo, which stages each collective
   through the host, so nothing here is a scaling figure: each trainer's
   ``train_step`` at the width of its phase (DCP at the CLI's defaults
   with its cycle term, FMR at ``FMRConfig``'s, RPM-Net at
   ``RPMNetConfig``'s, all at lr 1e-6) on the first training batch, 2
   steps in one process and then, from the same weights, batch and
   uniforms, on 2 spawned ranks under (dp, sp) = (2, 1) and (1, 2), the
   steps taking one process's lines and ball indices (``shard_steps``
   says why). Bars: ``batch_lines`` on one process's first-step inputs
   gives each rank that process's rows and line shard bit for bit; under
   sp so do the lines each rank draws and its first step's stage-1 counts
   on one process's lines (under dp both are printed: the network at B =
   2 rounds otherwise than at B = 4, cuBLAS choosing its kernels by shape,
   which moves knife-edge lines and hits); each stage-1 launch over L/sp
   lines and each resampler launch over the global B, the launches of a
   step exact; the first step's loss equal under sp and within 1e-4
   relative under dp (the bar between paths that round differently), the
   second's within 2e-3 (its parameters apart by Adam's sign noise: the
   bar of each side's own forward in phase 17); the gradient (Adam's
   first moment after the first step) within 5e-4 relative L2 (RPM-Net:
   or no farther from a float64 gradient than twice the farther of two
   fp32 paths, one process on the card and the CPU, as in phase 17:
   ``rpm_f64_gradient``); the second step's gradient (from Adam's first
   moments) within 5e-3 relative L2 and the second moment within twice
   that (under dp the network rounds at B = 2 again, and FMR's Jacobian
   amplifies it); the parameters
   after 2 steps within 1e-5 and equal on both ranks, and their update
   within 0.25 relative L2 of one process's (at lr 1e-6 the 1e-5 cannot
   tell a wrong update from a right one). Per rank its ms a step and the
   collectives' ms. Then DCP's CLI on 4 ranks (``--dp 2 --sp 2``) for an
   epoch at lr 0: one metrics log and a checkpoint, from rank 0; its test
   losses within 1e-5 of the CLI in one process (the test batches of 1 go
   whole to every rank) and its train losses within 3e-3 (the network at
   B = 2 moves knife-edge lines);
21. (run after phase 11) the classical runner's CUDA graph
   (``classical_graph_phase``, ``train/graphs.py``): 250 epochs of
   ``_loop`` at ``bench.py``'s widths, single and then the 4 pairs of
   phase 11, twice eagerly and once through the graph (its first epoch
   eager, then a replay an epoch) from the same seed; where the two eager
   runs are equal bit for bit, every epoch's loss, chamfer and valid flag,
   the twists, both moments, the count and the moved source of the graph's
   run equal theirs bit for bit (else the nondeterministic op is named and
   the bar is 1e-5 relative, ``held_to_eager``); launches exact by kind in
   every run, the graph counting 1 stage-1 and 1 resampler launch a
   replay; a 20-epoch profile of the graph's epochs that fails on a host
   copy or wait; it/s (pair-it/s) and peak memory of both, and the rate of
   250 more epochs of replays alone. The demo (phase
   12) and every ``run`` and ``run_batch`` on the card go through the
   graphs too, and its planted-motion checks stand;
22. (run after phase 16) ``Trainer.fit``'s scanned epoch
   (``scanned_phase``) for DCP at its CLI's defaults, FMR at
   ``FMRConfig``'s width and RPM-Net at ``RPMNetConfig``'s (after its one
   pretraining epoch) on phase 14's files: the CLI for 2 epochs twice
   streaming (``ARRL_NO_DEVICE_CACHE=1``) and once from the
   ``DeviceCache`` through the graphs (the network, loss and update
   captured in pieces around the SVD solves, which stay eager), held to
   the streaming runs by the same rule (every epoch's train and test
   metrics, the parameters and the Adam state), the same launches, the
   train and the test metrics each fetched from the card once an epoch;
   the train step's ms through the graphs and eagerly in turns, one graphed
   step's launches (device kernels, host launches, graphs, waits) and the
   kernels each captured piece replays. Phases 15 to 18 train from the
   ``DeviceCache`` and so through the same graphs (phase 17's launch checks
   by kind of step count each scanned step).

Every traced window opens with ``PRIME`` spin kernels: once the card has
idled, the tracer drops the first device records of each window, whatever
kernel they belong to (``tools/tracer_records.py``), and the spin kernels
take that loss.

Each phase's wall time is printed as it ends and all of them together
before the kernels line. Every phase that drives a path sets the launch
counters to 0 just before
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
# spin kernels that open every traced window: once the card has idled, the
# tracer drops the first device records of each window, whatever kernel they
# belong to (tools/tracer_records.py); these absorb the loss
PRIME, PRIME_CYCLES = 64, 100_000
PRIME_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel, left out of every count
B2, N2, F2, L2 = 32, 1024, 1024, 5000  # BASELINE config 2
WARMUP2, TIMED2, PROFILED2 = 2, 20, 5
B3, N3, F3, L3, BATCHES3 = 4, 1024, 1024, 15000, 8  # the DCP path
GRAD_ITERS3, PROFILED3 = 10, 5
TEST3 = 4  # DCP training's test batches
B1, WARMUP1, TIMED1, PROFILED1 = 4, 10, 50, 10  # the batched classical path
DEMO_EPOCHS, DEMO_LOG_EVERY = 200, 20
# the demo's last transform against the planted motion on noisy pairs: half
# the least planted rotation (rad; Adam's steps at lr 1e-2 keep the twist
# 0.0015 to 0.027 rad off it, epochs 50 to 300, tools/exact_copy_drift.py
# --noisy) and the same in cloud units; on exact copies the least chamfer and
# the nearest logged transform
DEMO_ROT_TOL, DEMO_TRANS_TOL = 0.05, 0.05
DEMO_EXACT_CHAMFER, DEMO_EXACT_TOL = 1e-6, 0.005
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


def timed(seconds, name, fn, *args):
    """Run one phase, ``fn(*args)``, and keep its wall time in ``seconds``."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds[name] = round(time.perf_counter() - t0, 2)
    print(f"phase {name}: {seconds[name]} s", flush=True)
    return out


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


def prime(torch):
    """Open a traced window with ``PRIME`` spin kernels (``PRIME_KERNEL``)
    before the work it measures."""
    for _ in range(PRIME):
        torch.cuda._sleep(PRIME_CYCLES)


def kernel_ms(torch, fn, reps, kernel=None, per_call=1, split=None):
    """Mean device time per call of fn over reps calls, read from
    torch.profiler: of the ``per_call`` kernels a call launches once each
    whose names hold ``kernel`` (their times added), or, with no name, of
    everything fn puts on the device (a library call, whose kernels' names
    are not ours to know). Back to back, a wrapper's host work can outlast
    its kernel, and CUDA events around the calls would then time the host.
    Each named kernel must show all of its reps launches, and a library call
    some device activity. Once the card has idled, the tracer drops the
    first device records of every window, so each window opens with
    ``prime``'s spin kernels, which take that loss; it also loses a whole
    window now and then, so a window that shows fewer is traced again, and
    after ``TRACE_TRIES`` windows the check fails.
    ``split``, a dict of {key: part of a kernel's name}, is filled with each
    part's mean ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prime(torch)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA and PRIME_KERNEL not in e.name
                    and (kernel is None or kernel in e.name)):
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


def profile_phase(torch, one, n, what, ms_per, units=1, strict=True, label=None):
    """Where the time of ``n`` calls of ``one`` goes, under torch.profiler;
    a call covers ``units`` steps, iterations or batches (``what``). Prints
    the kernels, the device time and its share of the unprofiled ``ms_per``,
    all per unit, and the costliest device operations. Fails if a call
    copies between host and device or waits for the device, unless not
    ``strict``: then it counts them. With a ``label``, also the device time
    of the spans of that name and of their backward (``labelled_ms``).
    Returns those numbers per unit (None when the tracer recorded no device
    activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime(torch)
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
        if (e.device_type == DeviceType.CUDA and e.name not in ("chip_smoke.call", label)
                and PRIME_KERNEL not in e.name):
            tot, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), calls + 1)
    copies = sum(c for k, (_, c) in by_name.items()
                 if k.startswith(("Memcpy HtoD", "Memcpy DtoH")))
    htod = sum(c for k, (_, c) in by_name.items() if k.startswith("Memcpy HtoD"))
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
              f"{ms_per:.4f} ms/{what}; host<->device copies {copies} ({htod} to the "
              f"device); sync calls "
              f"{syncs}", flush=True)
        for name, (tot, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"  {tot / 1e3 / n:9.4f} ms/{what} {calls / n:6.1f}/{what}  "
                  f"{name[:90]}", flush=True)
    if strict:
        check(copies == 0, f"{copies} host<->device copies in {n} {plural}")
        check(not any(syncs.values()), f"the {what} waits for the device: {syncs}")
    if not by_name:
        return None
    out = dict(kernels=kernels / n, busy_ms=busy, busy_share=busy / ms_per, copies=copies,
               htod=htod, syncs=sum(syncs.values()),
               ms_by_kernel={k: t / 1e3 / n for k, (t, _) in by_name.items()})
    if label is not None:
        out["labelled_ms"] = labelled_ms(events, label) / n
    return out


def labelled_events(events, label):
    """A trace's host events inside record_function spans named ``label``,
    and those of the backward nodes that the operations of those spans
    made (matched by sequence number and thread, as the profiler's own
    forward-backward correlation does), the engine's reduction of a
    node's gradients to its inputs' shapes included."""
    from torch.autograd import DeviceType

    def under(e, pred):
        while e is not None:
            if pred(e):
                return e
            e = e.cpu_parent
        return None

    def node_key(p):
        """(sequence number, forward thread) of the backward node whose
        span p is, or whose engine span (the node and the reduction of its
        outputs) p is."""
        if p.scope == 1:
            return p.sequence_nr, p.fwd_thread
        if p.name.startswith("autograd::engine::evaluate_function"):
            for c in p.cpu_children:
                if c.scope == 1:
                    return c.sequence_nr, c.fwd_thread
        return None

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    fwd = {(e.sequence_nr, e.thread) for e in cpu
           if e.sequence_nr >= 0 and under(e, lambda p: p.name == label)}
    return [e for e in cpu if under(e, lambda p: p.name == label or node_key(p) in fwd)]


def labelled_ms(events, label):
    """The device ms of the kernels that ``labelled_events`` launched."""
    return sum(k.duration for e in labelled_events(events, label) for k in e.kernels) / 1e3


class _Spans:
    """Wraps every forward of ``model``'s modules of type ``cls`` in a
    record_function span named ``label`` while entered."""

    def __init__(self, model, cls, label):
        self.mods, self.label, self.open = [m for m in model.modules() if isinstance(m, cls)], \
            label, []

    def __enter__(self):
        from torch.profiler import record_function

        def enter(mod, args):
            self.open.append(record_function(self.label).__enter__())

        def leave(mod, args, out):
            self.open.pop().__exit__(None, None, None)

        self.hooks = [h for m in self.mods for h in (m.register_forward_pre_hook(enter),
                                                     m.register_forward_hook(leave))]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def main_path(torch, classical, se3, G, M, IK, RS, PB, LN, data, cfg):
    """prepare_pair's data -> 50 + 200 epochs of make_step, then the
    profiled window; returns (the launches per kernel in the 250 epochs,
    the timed epochs' it/s)."""
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
    return launches, TIMED / dt


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
    with torch.no_grad():
        seen = [torch.linalg.svdvals(model.pre_solve(batch["points_src_sample"],
                                                     batch["points_tar_sample"])[0])
                for batch in batches]
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


def synthetic_pairs(B, n, exact=False):
    """B pairs in ``bench.py``'s shape: pair s is made from seed s, a
    Fibonacci ellipsoid with 0.01 noise as its source and its target moved by
    a known small rigid motion (``planted_motion(s)``). The target is the
    moved source itself when ``exact``, else the ellipsoid noised a second
    time and moved."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    th = np.pi * (1 + 5**0.5) * i
    p = np.stack([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th), np.cos(phi)], -1)
    p = (p * np.array([1.0, 0.7, 0.5])).astype(np.float32)
    srcs, tars = [], []
    for s in range(B):
        rng = np.random.default_rng(s)
        R, t = planted_motion(s)
        srcs.append(p + rng.standard_normal(p.shape).astype(np.float32) * 0.01)
        moved = srcs[-1] if exact else p + rng.standard_normal(p.shape).astype(np.float32) * 0.01
        tars.append(moved @ R + t)
    return np.stack(srcs), np.stack(tars)


def planted_motion(s):
    """Pair s's motion, row convention (target = source @ R + t): a rotation
    of 0.1 + 0.05 s rad about z and a fixed shift."""
    a = 0.1 + 0.05 * s
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    return R, np.float32([0.02, -0.01, 0.03])


def motion_error(transform, s):
    """The demo's 3 x 4 [R | t] between the centred clouds against pair s's
    planted motion, which maps the centred source onto the centred target by
    R alone: (the angle of R_est^T R in rad, |t_est|)."""
    R, _ = planted_motion(s)
    c = (np.trace(np.asarray(transform[:, :3], np.float64).T @ R) - 1) / 2
    return float(np.arccos(np.clip(c, -1.0, 1.0))), float(np.linalg.norm(transform[:, 3]))


def classical_batch_phase(torch, classical, IK, RS, PB, LN, single_its):
    """The batched classical path (module docstring, phase 11): B1 pairs,
    WARMUP1 + TIMED1 epochs of ``make_batch_step`` with one resampler and one
    stage-1 launch an epoch for all of them, a profile that fails on a host
    copy or wait, then one batched epoch against B1 single ``update``s on
    the same lines and twists. Returns the launches of the driven epochs."""
    cfg = classical.ClassicalConfig(n_lines=N_LINES, num_sample=N_FACES,
                                    compute_chamfer=False)
    src, tar = synthetic_pairs(B1, N_CLOUD)
    t0 = time.perf_counter()
    data = classical.prepare_pairs(src, tar, cfg, device=DEV)
    torch.cuda.synchronize()
    print(f"prepare_pairs: B={B1}, {time.perf_counter() - t0:.2f} s, "
          f"F={data['neis_src'].shape[1]}", flush=True)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = torch.stack([classical.init_twist(gen) for _ in range(B1)])
    carry = (params, classical.init_adam(params), data["src"])
    step = classical.make_batch_step(cfg, data)
    u4 = lambda: torch.rand((B1, 4, LN.ROUNDS * cfg.n_lines), generator=gen, device=DEV)

    losses, valids = [], []
    torch.cuda.synchronize()
    counts(IK, RS, PB, reset=True)
    for e in range(WARMUP1 + TIMED1):
        if e == WARMUP1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        carry, m = step(carry, u4())
        losses.append(m["loss"])
        valids.append(m["valid"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts(IK, RS, PB)
    n = WARMUP1 + TIMED1
    check_counts(launches, {"resample_batched": 1, "stage1_pair_pts": 1}, n,
                 "classical batch")
    losses = torch.stack(losses).cpu().numpy()
    check(losses.shape == (n, B1) and np.isfinite(losses).all(), "a batched loss is not finite")
    check(bool(torch.stack(valids).all()), "a pair had no usable line in an epoch")
    ms = 1e3 * dt / TIMED1
    pair_its = B1 * TIMED1 / dt
    print(f"classical batch: B={B1}, {n} epochs, F={N_FACES}, L={N_LINES}: {ms:.4f} ms/epoch, "
          f"{pair_its:.2f} pair-iterations/s over the last {TIMED1} (the single step: "
          f"{single_its:.2f} it/s, ratio {pair_its / single_its:.2f}); loss per pair "
          f"{losses[0]} -> {losses[-1]}; launches {launches}", flush=True)
    state = {"carry": carry}

    def one_epoch():
        state["carry"], _ = step(state["carry"], u4())

    profile_phase(torch, one_epoch, PROFILED1, "epoch", ms)
    carry = state["carry"]

    # one batched epoch against B1 single updates on the same lines and twists
    lines = LN.resample_lines(u4(), data["radius"], data["center"], cfg.n_lines, carry[2],
                              data["tar"])
    (pb, ob, _), mb = classical.batch_update(cfg, data, carry, lines)
    singles = []
    for b in range(B1):
        one = {k: v[b] for k, v in data.items()}
        opt = classical.AdamState(carry[1].count, carry[1].mu[b], carry[1].nu[b])
        singles.append(classical.update(cfg, one, (carry[0][b], opt, carry[2][b]), lines[b]))
    ls = torch.stack([m["loss"] for _, m in singles])
    ps = torch.stack([c[0] for c, _ in singles])
    lerr = float(((mb["loss"] - ls).abs() / ls.abs()).max())
    perr = float((pb - ps).abs().max())
    print(f"classical batch vs {B1} single updates on the same lines: loss rel err {lerr:.3g}, "
          f"twist max abs err {perr:.3g}", flush=True)
    check(bool(mb["valid"].all()), "no usable line in the batch-vs-single check")
    check(lerr <= 1e-5, f"batched loss vs single: {lerr}")
    check(perr <= 1e-5, f"batched twists vs single: {perr}")
    return launches


GRAPH_EPOCHS, GRAPH_PROFILED = 250, 20  # the graph phases' epochs per run, and profiled
GRAPH_REL = 1e-5  # graph against eager where two eager runs differ (the resume bar)


def _named(torch, prefix, tree):
    """{prefix i: leaf i on the host} over a pytree's leaves."""
    from torch.utils import _pytree

    return {f"{prefix} {i}": x.detach().cpu().numpy()
            for i, x in enumerate(_pytree.tree_leaves(tree))}


def spread(a, b):
    """{name: relative difference} of the arrays that differ between two
    dicts of arrays, each difference over the larger magnitude of b's
    array."""
    out = {}
    for k in b:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if not np.array_equal(x, y):
            out[k] = float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
    return out


def held_to_eager(what, eager, again, graph, nondeterministic):
    """The bit-for-bit rule: where two eager runs agree bit for bit, the
    graph's run must equal them bit for bit; where they do not, the
    nondeterministic op is named and the graph is held to GRAPH_REL. Each
    argument is a dict of named arrays. Returns (the largest relative
    difference of the graph's run, of the second eager run)."""
    gaps, noises = spread(graph, eager), spread(again, eager)
    gap, noise = max(gaps.values(), default=0.0), max(noises.values(), default=0.0)
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
    if noise == 0.0:
        print(f"{what}: two eager runs equal bit for bit; the graph's run "
              f"{'equal bit for bit' if gap == 0.0 else f'differs by {gap:.3g}: {worst}'}",
              flush=True)
        check(gap == 0.0, f"{what}: the graph differs from the eager runs where two eager runs "
              f"are equal: {worst}")
    else:
        print(f"{what}: two eager runs differ by {noise:.3g} relative ({nondeterministic}); "
              f"the graph's run by {gap:.3g} (bar {GRAPH_REL:g}): {worst}", flush=True)
        check(gap <= GRAPH_REL, f"{what}: the graph differs by {gap:.3g} > {GRAPH_REL:g}: "
              f"{worst}")
    return gap, noise


def classical_graph_phase(torch, classical, IK, RS, PB, LN, batched):
    """The classical runner's CUDA graph (module docstring, phase 21):
    GRAPH_EPOCHS epochs of ``_loop`` at ``bench.py``'s widths, single or
    B1 pairs (the classical-batch phase's), twice eagerly and once through
    the graph from the same seed; the graph's history and final carry held
    to the eager runs' (``held_to_eager``), launches exact by kind in each
    run, a profile of the graph's epochs that fails on a host copy or wait,
    the rates and peak memory of both. Returns the graph run's launches and
    numbers."""
    cfg = classical.ClassicalConfig(n_epochs=GRAPH_EPOCHS, n_lines=N_LINES,
                                    num_sample=N_FACES, compute_chamfer=False)
    if batched:
        src, tar = synthetic_pairs(B1, N_CLOUD)
        data = classical.prepare_pairs(src, tar, cfg, device=DEV)
        step = classical.make_batch_step(cfg, data)
        per, kinds = B1, {"resample_batched": 1, "stage1_pair_pts": 1}
    else:
        src, tar = synthetic_pair()
        data = classical.prepare_pair(src, tar, cfg, device=DEV)
        step = classical.make_step(cfg, data)
        per, kinds = 1, {"resample_sample_and_hit": 1, "stage1_pair_pts": 1}
    what = f"classical {'batch (B=' + str(B1) + ')' if batched else 'single'} graph"

    def init(gen):
        if batched:
            return torch.stack([classical.init_twist(gen) for _ in range(B1)])
        return classical.init_twist(gen)

    runs = {}
    for mode in ("eager", "eager again", "graph"):
        gen = gen_on(torch, cfg.seed)
        params = init(gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts(IK, RS, PB, reset=True)
        t0 = time.perf_counter()
        carry, hist = classical._loop(cfg, step, params, data["src"], gen, None,
                                      mode=mode.split()[0])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counts(IK, RS, PB)
        check_counts(launches, kinds, GRAPH_EPOCHS, f"{what}, {mode}")
        check(np.isfinite(hist["loss"]).all() and hist["valid"].all(),
              f"{what}, {mode}: a loss is not finite or an epoch had no usable line")
        runs[mode] = dict(state={**hist, **_named(torch, "carry", carry)},
                          its=per * GRAPH_EPOCHS / dt, launches=launches,
                          peak=torch.cuda.max_memory_allocated() / 2**20,
                          loss=hist["loss"][-1])
    gap, noise = held_to_eager(f"{what}: {GRAPH_EPOCHS} epochs' losses, chamfers, valid flags, "
                               "twists, both moments, count and moved source",
                               runs["eager"]["state"], runs["eager again"]["state"],
                               runs["graph"]["state"],
                               "the slots' index_add_ of ops/metric.py is atomic on the card")
    unit = "pair-it/s" if batched else "it/s"
    g, e = runs["graph"], runs["eager"]
    print(f"{what}: {GRAPH_EPOCHS} epochs through the graph {g['its']:.2f} {unit} against eager "
          f"{e['its']:.2f} and {runs['eager again']['its']:.2f} (the first epoch eager in "
          f"each, the capture included: {g['its'] / e['its']:.2f} times); peak device memory "
          f"{g['peak']:.1f} MiB against {e['peak']:.1f}; final loss {g['loss']}; launches "
          f"{g['launches']}", flush=True)

    # the profile of the graph's epochs: one replay each, no copy or wait
    gen = gen_on(torch, cfg.seed)
    params = init(gen)
    carry = (params, classical.init_adam(params), data["src"])
    u4_shape = params.shape[:-1] + (4, LN.ROUNDS * cfg.n_lines)
    state = dict(mode="graph", graph=None)
    carry, _ = classical._static_block(step, carry, u4_shape, gen, 1, state)
    ms = 1e3 * per / g["its"]
    prof = profile_phase(torch, lambda: classical._static_block(step, carry, u4_shape, gen, 1,
                                                                state),
                         GRAPH_PROFILED, "epoch", ms)
    graph = state["graph"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    classical._static_block(step, carry, u4_shape, gen, GRAPH_EPOCHS, state)
    torch.cuda.synchronize()
    steady = per * GRAPH_EPOCHS / (time.perf_counter() - t0)
    print(f"{what}: {GRAPH_EPOCHS} more epochs of replays alone {steady:.2f} {unit} "
          f"({steady / e['its']:.2f} times eager's run); per replay the graph counts "
          f"{graph.counts}", flush=True)
    check(graph.counts == {("stage1", IK.instantiation(*STAGE1["stage1_pair_pts"])): 1,
                           ("resample", "batched" if batched else "single"): 1},
          f"{what}: the graph's launches per replay {graph.counts}")
    state.clear()
    return g["launches"], dict(graph_its=g["its"], graph_steady_its=steady, eager_its=e["its"],
                               eager_again_its=runs["eager again"]["its"],
                               graph_peak_mib=g["peak"], eager_peak_mib=e["peak"],
                               gap=gap, eager_spread=noise, profile=prof)


SCAN_EPOCHS = 2  # the scanned-epoch phase's epochs per run
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def launch_profile(torch, fn, n=1):
    """Per call of ``fn`` over ``n`` calls under torch.profiler: (the device
    kernels, the kernels the host launched itself, the graphs it launched,
    its waits for the device); None for the device kernels when the tracer
    recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime(torch)
        for _ in range(n):
            with record_function("chip_smoke.call"):
                fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "chip_smoke.call" and e.device_type != DeviceType.CUDA]
    host = [e for e in events if e.device_type != DeviceType.CUDA
            and any(a <= e.time_range.start < b for a, b in spans)]
    kernels = sum(e.device_type == DeviceType.CUDA and PRIME_KERNEL not in e.name
                  and e.name != "chip_smoke.call"
                  and not e.name.startswith(("Memcpy", "Memset")) for e in events)
    return ((kernels / n) if kernels else None,
            sum(e.name in LAUNCH_CALLS for e in host) / n,
            sum(e.name.startswith("cudaGraphLaunch") for e in host) / n,
            sum(e.name in SYNC_CALLS for e in host) / n)


def _n(x):
    return "not measured" if x is None else f"{x:.1f}"


def scanned_phase(torch, mods, data, tmp, name):
    """``Trainer.fit``'s scanned epoch for DCP, FMR or RPM-Net (module
    docstring, phase 22): the trainer's CLI on the data phase's files at
    its phase's width for SCAN_EPOCHS epochs (RPM-Net's after its one
    pretraining epoch), twice streaming (``ARRL_NO_DEVICE_CACHE=1``)
    and once from the ``DeviceCache`` through the graphs, from the same
    seed: every epoch's train and test metrics and the final parameters and
    Adam state held to the streaming runs' (``held_to_eager``), the same
    launches, the train and test metrics each fetched once an epoch. Then,
    on a throwaway model, the train step's ms through the graphs against
    eager in turns, the launches of one graphed step (on the device, from
    the host, graphs, waits) and the kernels each captured piece replays.
    Returns the scanned run's launches and numbers."""
    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.train import dcp as TD
    from a_robust_registration_loss_tpu_torch.train import fmr as TF
    from a_robust_registration_loss_tpu_torch.train import harness as H

    from a_robust_registration_loss_tpu_torch.train import rpmnet as TR

    G, M, IK, RS, PB = mods[:5]
    mod = {"dcp": TD, "fmr": TF, "rpm": TR}[name]
    args = ["--data_path", data, "--layout", "views", "--train_count", str(TRAIN5),
            "--batch_size", str(B5), "--seed", "0", "--device", DEV, "--epochs",
            str(SCAN_EPOCHS)] + {
                "dcp": ["--n_lines", str(L5)] + DCP_CLI, "fmr": ["--n_lines", str(L5)] + FMR_CLI,
                "rpm": ["--n_lines", str(L_RPM), "--pretrain_epochs", "1"] + RPM_CLI}[name]
    steps, n_test = TRAIN5 // B5, 6 * VIEWS5 - TRAIN5
    fetch, train, fetches, seen = H._fetch, mod.train, [], {}
    H._fetch = lambda rows: fetches.append(tuple(rows.shape)) or fetch(rows)

    def spy(cfg, *a, **k):  # the CLI's configuration
        seen["cfg"] = cfg
        return train(cfg, *a, **k)

    mod.train = spy
    env = os.environ.pop("ARRL_NO_DEVICE_CACHE", None)
    runs = {}
    try:
        for label in ("streaming", "streaming again", "scanned"):
            if label.startswith("streaming"):
                os.environ["ARRL_NO_DEVICE_CACHE"] = "1"
            else:
                os.environ.pop("ARRL_NO_DEVICE_CACHE", None)
            exp = os.path.join(tmp, f"scan_{name}_{label.replace(' ', '_')}")
            fetches.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts(IK, RS, PB, reset=True)
            t0 = time.perf_counter()
            model, state, hist = mod.main(args + ["--exp_dir", exp])
            torch.cuda.synchronize()
            runs[label] = dict(
                hist=hist, secs=_epoch_seconds(exp), wall=time.perf_counter() - t0,
                launches=counts(IK, RS, PB), fetches=list(fetches),
                peak=torch.cuda.max_memory_allocated() / 2**20,
                state={**{f"epoch {h['epoch']} {k}": v for h in hist for k, v in h.items()},
                       **_named(torch, "parameter", list(model.parameters())),
                       **_named(torch, "adam", state)})
    finally:
        H._fetch, mod.train = fetch, train
        os.environ.pop("ARRL_NO_DEVICE_CACHE", None)
        if env is not None:
            os.environ["ARRL_NO_DEVICE_CACHE"] = env
    st, sc = runs["streaming"], runs["scanned"]
    what = f"{name.upper()} scanned epoch"
    check([sorted(h) for h in sc["hist"]] == [sorted(h) for h in st["hist"]],
          f"{what}: the metrics' names differ from the streaming run's")
    check(sc["launches"] == st["launches"],
          f"{what}: launches {sc['launches']} against streaming {st['launches']}")
    main = sc["fetches"][-2 * SCAN_EPOCHS:]  # after RPM-Net's pretraining epoch's
    check(st["fetches"] == [] and len(sc["fetches"]) == 2 * SCAN_EPOCHS + (name == "rpm")
          and main[::2] == [(steps, main[0][1])] * SCAN_EPOCHS
          and all(f[0] == n_test for f in main[1::2])
          and all(f[0] == steps for f in sc["fetches"][:-2 * SCAN_EPOCHS]),
          f"{what}: the stacked metrics fetched {sc['fetches']} (want one train and one test "
          f"fetch an epoch)")
    gap, noise = held_to_eager(
        f"{what}: {SCAN_EPOCHS} epochs' train and test metrics, parameters, Adam state",
        st["state"], runs["streaming again"]["state"], sc["state"],
        "cuBLAS or the atomics of index_add_")

    # the train step alone, on a throwaway model: graphs against eager, in turns
    cfg = seen["cfg"]
    loader, _ = DS.generate_datasets(DS.DatasetConfig(
        data_path=data, layout="views", train_count=TRAIN5, train_batch=B5, seed=0,
        dcp=name == "dcp", fmr=name == "fmr"), device=DEV)
    cache = DS.DeviceCache(loader, DEV)
    model = mod.init_model(cfg, 1, DEV)
    box = {"opt": (H.scheduled_adam_init if name == "rpm" else H.adam_init)(model.parameters())}
    gen = gen_on(torch, 0)
    _, full, _ = cache.next_epoch()
    scan = H._Scan(mod.train_split(cfg), model, cache, B5)

    def eager_epoch():
        for row in full:
            box["opt"], _ = mod.train_step(model, box["opt"], cache.gather(row), cfg,
                                           generator=gen)

    def scanned_epoch():
        for row in full:
            box["opt"], _ = scan(row, gen, box["opt"])

    ms = {"eager": [], "graph": []}
    for label, fn in (("graph", scanned_epoch), ("eager", eager_epoch),
                      ("eager", eager_epoch), ("graph", scanned_epoch),
                      ("graph", scanned_epoch), ("eager", eager_epoch)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms[label].append(1e3 * (time.perf_counter() - t0) / len(full))
    ms = {k: v[1:] if k == "graph" else v for k, v in ms.items()}  # the first builds
    one = lambda: scan(full[0], gen, box["opt"])
    g_kernels, g_host, g_graphs, g_waits = launch_profile(torch, one, 3)
    step = scan.step
    pieces = {"gather": step.gather.graph, "update": step.update.graph}
    for i, seg in enumerate(step.pieces):
        pieces.update({f"piece {i} forward": seg.fwd, f"piece {i} backward": seg.bwd})
    per_piece = {k: launch_profile(torch, g.replay)[0] for k, g in pieces.items()}
    e_kernels, e_host, _, e_waits = launch_profile(
        torch, lambda: mod.train_step(model, box["opt"], cache.gather(full[0]), cfg,
                                      generator=gen), 3)
    print(f"{what}: {SCAN_EPOCHS} epochs of {steps} steps and {n_test} test batches, "
          f"time/epoch_seconds {sc['secs']} against streaming {st['secs']} and "
          f"{runs['streaming again']['secs']} (wall {sc['wall']:.2f} s against "
          f"{st['wall']:.2f} s, CLI and data included); peak {sc['peak']:.1f} MiB against "
          f"{st['peak']:.1f}; fetches {sc['fetches']}; launches {sc['launches']}", flush=True)
    print(f"{what}: train step {[round(x, 4) for x in ms['graph']]} ms through the graphs "
          f"against eager {[round(x, 4) for x in ms['eager']]} (turns graph, eager, eager, "
          f"graph, graph, eager; the first graph epoch, which captures, left out); a graphed "
          f"step: {_n(g_kernels)} kernels on the device, {g_host:.1f} launched by the host, "
          f"{g_graphs:.1f} graphs, {g_waits:.1f} waits; eager: {_n(e_kernels)} kernels, "
          f"{e_host:.1f} launched by the host, {e_waits:.1f} waits; kernels per captured piece "
          f"(each replaced by one graph launch) "
          f"{ {k: _n(v) for k, v in per_piece.items()} }", flush=True)
    return sc["launches"], dict(
        secs=sc["secs"], stream_secs=st["secs"], stream_again_secs=runs["streaming again"]["secs"],
        graph_ms=ms["graph"], eager_ms=ms["eager"], graph_step=(g_kernels, g_host, g_graphs,
                                                                 g_waits),
        eager_step=(e_kernels, e_host, e_waits), per_piece=per_piece, gap=gap,
        eager_spread=noise, peak=sc["peak"], stream_peak=st["peak"])


def demo_phase(torch, demo, IK, RS, PB):
    """The demo through its ``cli`` (module docstring, phase 12): the B1
    synthetic pairs as OBJ files, noisy and then exact copies, each once
    single (label 0) and once batched (every label), DEMO_EPOCHS epochs each
    at the demo's default widths. Returns the launches of all four runs,
    added."""
    import importlib.util
    import tempfile

    from a_robust_registration_loss_tpu_torch.data import objio

    png = importlib.util.find_spec("matplotlib") is not None
    total = {}
    for kind in ("noisy", "exact"):
        src, tar = synthetic_pairs(B1, N_CLOUD, exact=kind == "exact")
        with tempfile.TemporaryDirectory() as tmp:
            for i in range(B1):
                objio.write_obj(os.path.join(tmp, f"{i}_src_sample.obj"), src[i])
                objio.write_obj(os.path.join(tmp, f"{i}_tar_sample.obj"), tar[i])
            base = ["--data_path", tmp, "--n_epochs", str(DEMO_EPOCHS), "--log_every",
                    str(DEMO_LOG_EVERY)]
            labels = ",".join(str(i) for i in range(B1))
            runs = (("single", ["--label1", "0"], "resample_sample_and_hit"),
                    ("batched", ["--labels", labels], "resample_batched"))
            for what, extra, resampler in runs:
                out = os.path.join(tmp, what)
                torch.cuda.synchronize()
                counts(IK, RS, PB, reset=True)
                t0 = time.perf_counter()
                hist = demo.cli(base + extra + ["--Save_path", out])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launches = counts(IK, RS, PB)
                check_counts(launches, {resampler: 1, "stage1_pair_pts": 1}, DEMO_EPOCHS,
                             f"demo {kind} {what}")
                files = set(os.listdir(out))
                logged = range(DEMO_LOG_EVERY, DEMO_EPOCHS + 1, DEMO_LOG_EVERY)
                if what == "single":
                    want = {f"{e}{suffix}" for e in logged for suffix in (".obj", "_transform.txt")}
                    want |= {"target.obj", "source_pre.ply", "source.ply", "target.ply"}
                    want |= {"registration.png"} if png else set()
                else:
                    want = {f"{i}_transform.txt" for i in range(B1)}
                check(files == want, f"demo {kind} {what}: files {sorted(files ^ want)} differ")
                ch = hist["chamfer"].reshape(DEMO_EPOCHS, -1)
                check(np.isfinite(ch).all(), f"demo {kind} {what}: a chamfer is not finite")
                # the transforms against the planted motions: the last one of
                # every pair, and in single mode each logged one of pair 0
                last = ([np.loadtxt(os.path.join(out, f"{DEMO_EPOCHS}_transform.txt"))]
                        if what == "single" else
                        [np.loadtxt(os.path.join(out, f"{i}_transform.txt")) for i in range(B1)])
                err = np.array([motion_error(T, i) for i, T in enumerate(last)])
                print(f"demo {kind} {what}: {DEMO_EPOCHS} epochs in {dt:.2f} s (set-up and files "
                      f"included), chamfer first {ch[0]}, least {ch.min(0)} at epochs "
                      f"{ch.argmin(0)}, last {ch[-1]}; last transform against the planted "
                      f"motion: rotation error {err[:, 0]} rad, translation error "
                      f"{err[:, 1]}; {len(files)} files; launches {launches}", flush=True)
                if kind == "noisy":
                    check((ch[-1] < ch[0]).all(), f"demo {kind} {what}: chamfer {ch[0]} -> "
                          f"{ch[-1]}")
                    check((err[:, 0] <= DEMO_ROT_TOL).all() and (err[:, 1] <= DEMO_TRANS_TOL).all(),
                          f"demo {kind} {what}: last transform off the planted motion: {err}")
                else:
                    # noise-free copies: registered to the rounding level, then
                    # possibly knocked off by the metric's median collapse (the
                    # reference's Adam and metric; PERF.md, ROADMAP.md Queue 3)
                    check((ch.min(0) <= DEMO_EXACT_CHAMFER).all(),
                          f"demo {kind} {what}: least chamfer {ch.min(0)} never reached "
                          f"{DEMO_EXACT_CHAMFER}")
                    if what == "single":
                        errs = [motion_error(np.loadtxt(os.path.join(out, f"{e}_transform.txt")), 0)
                                for e in logged]
                        best = min(errs)  # the least rotation error
                        check(best[0] <= DEMO_EXACT_TOL and best[1] <= DEMO_EXACT_TOL,
                              f"demo {kind} {what}: no logged transform near the planted "
                              f"motion: {errs}")
                        print(f"demo {kind} {what}: logged transform nearest the planted motion: "
                              f"rotation error {best[0]:.3g} rad, translation {best[1]:.3g}",
                              flush=True)
                    for i in range(ch.shape[1]):
                        reached = np.flatnonzero(ch[:, i] <= DEMO_EXACT_CHAMFER)
                        reached = reached[0] if reached.size else DEMO_EPOCHS
                        left = np.flatnonzero(ch[reached:, i] > 100 * DEMO_EXACT_CHAMFER)
                        if left.size:
                            print(f"demo {kind} {what}: pair {i} left the planted motion at "
                                  f"epoch {reached + left[0]} (chamfer "
                                  f"{ch[reached + left[0], i]:.3g}, last {ch[-1, i]:.3g})",
                                  flush=True)
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
    return total


def dcp_train_phase(torch, mods, cfg3, batches):
    """DCP's training at full width (module docstring, phase 13): ``train``
    for 1 pretrain and 2 epochs with a test loader, the state a resume loads
    against the one saved, the resume to 3 epochs against an uninterrupted
    3-epoch run, a NaN batch, ``guarded_update`` on the card, and profiles.
    Returns the launches of the first ``train``."""
    import dataclasses
    import tempfile

    from a_robust_registration_loss_tpu_torch.train import harness as H

    G, M, IK, RS, PB, LS, GK, D, TD = mods
    tests = batches[:TEST3]
    quiet = lambda msg: None
    with tempfile.TemporaryDirectory() as tmp:
        def config(exp, epochs):
            fit = H.FitConfig(epochs=epochs, exp_dir=os.path.join(tmp, exp), save_every=1,
                              artifacts_every=1, seed=0)
            return dataclasses.replace(cfg3, pretrain_epochs=1, fit=fit)

        torch.cuda.synchronize()
        counts(IK, RS, PB, reset=True)
        t0 = time.perf_counter()
        model, state, hist = TD.train(config("run", 2), batches, tests, log=quiet,
                                      device=DEV)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counts(IK, RS, PB)
        steps = 2 * len(batches) + 2 * len(tests)  # train steps and eval batches
        check_counts(launches, {"resample_batched": 1, "stage1_pair_pts": 1}, steps,
                     "DCP train")
        run = os.path.join(tmp, "run")
        print(f"DCP train: 1 pretrain + 2 epochs of {len(batches)} batches, {len(tests)} "
              f"test batches: {dt:.2f} s; epoch seconds (pretrain, then train with eval, "
              f"checkpoint and artifacts) {_epoch_seconds(os.path.join(run, 'pretrain'))} "
              f"{_epoch_seconds(run)}; train loss "
              f"{[h['loss'] for h in hist]}; test loss_intersection "
              f"{[h['test_loss_intersection'] for h in hist]}; launches {launches}", flush=True)
        check(sorted(os.listdir(os.path.join(run, "checkpoints"))) == [
            "checkpoints.json", "ckpt-0", "ckpt-1", "ckpt-best"], "DCP train: checkpoints")
        check(len(os.listdir(os.path.join(run, "artifacts"))) == 8, "DCP train: artifacts")

        # the state a resume loads equals the state saved, bit for bit
        fresh = TD.init_model(cfg3, 99, DEV)
        loaded, start = H.Trainer(lambda *a: None, None, config("run", 3).fit,
                                  device=DEV).restore(fresh, H.adam_init(fresh.parameters()))
        saved = model.state_dict()
        check(start == 2, f"resume starts at epoch {start}")
        check(all(torch.equal(v, saved[k]) for k, v in fresh.state_dict().items()),
              "the resumed parameters differ from the saved ones")
        check(all(torch.equal(a, b) for a, b in zip(loaded, state)),
              "the resumed optimiser state differs from the saved one")

        _, _, resumed = TD.train(config("run", 3), batches, tests, log=quiet,
                                 device=DEV)
        _, _, full = TD.train(config("full", 3), batches, tests, log=quiet, device=DEV)
        # the uninterrupted run against the first run (epochs 0 and 1) and
        # against the resumed one (epoch 2)
        errs = [abs(h["loss"] - f["loss"]) / abs(f["loss"])
                for h, f in zip(hist + resumed, full)]
        print(f"DCP resume: epoch {resumed[0]['epoch']} train loss {resumed[0]['loss']:.9f}, "
              f"uninterrupted {full[2]['loss']:.9f}; train loss rel err against the "
              f"uninterrupted run by epoch {[f'{e:.3g}' for e in errs]}; loaded state equal "
              "to the saved one bit for bit", flush=True)
        check([h["epoch"] for h in resumed] == [2], "the resume did not run epoch 2 alone")
        check(len(errs) == 3 and max(errs) <= 1e-5, f"train loss vs uninterrupted: {errs}")
        for h in hist + resumed + full:
            check(all(np.isfinite(v) for v in h.values()), f"a metric is not finite: {h}")
            check(h["nonfinite_steps"] == 0.0, f"a step was skipped: {h}")

    # a NaN batch: the model and the optimiser state stay as they were
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    poisoned = dict(batches[0])
    poisoned["points_src_sample"] = batches[0]["points_src_sample"].clone()
    poisoned["points_src_sample"][0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    after, m = TD.train_step(model, state, poisoned, cfg3, generator=gen)
    check(float(m["nonfinite_steps"]) == 1.0, "the NaN batch was not skipped")
    check(all(torch.equal(v, before[k]) for k, v in model.state_dict().items()),
          "the NaN batch changed the model")
    check(all(torch.equal(a, b) for a, b in zip(after, state)),
          "the NaN batch changed the optimiser state")

    # guarded_update on the card: one NaN, one inf among 5.6 M gradient
    # entries skip the step; a huge finite gradient does not
    params = list(model.parameters())
    grads = [torch.randn_like(p) for p in params]
    one_loss = torch.ones((), device=DEV)
    for bad in (float("nan"), float("inf")):
        g = [x.clone() for x in grads]
        g[len(g) // 2].view(-1)[7] = bad
        new, flag = H.guarded_update(cfg3.lr, g, state, params, one_loss)
        check(float(flag) == 1.0 and all(torch.equal(a, b) for a, b in zip(new, state)),
              f"guarded_update took a step with a {bad} gradient")
        check(all(torch.equal(v, before[k]) for k, v in model.state_dict().items()),
              f"guarded_update changed the model on a {bad} gradient")
    huge = [x * 1e37 for x in grads]
    new, flag = H.guarded_update(0.0, huge, state, params, one_loss)
    check(float(flag) == 0.0 and int(new.count) == int(state.count) + 1,
          "guarded_update skipped a finite gradient")
    print("DCP NaN batch skipped, model and optimiser state unchanged bit for bit; "
          "guarded_update skips a NaN or inf gradient entry, takes a 1e37 one", flush=True)

    # train_step alone: ms/iteration and its profile; guarded_update's share
    st = {"s": state, "i": 0}

    def one():
        st["s"], _ = TD.train_step(model, st["s"], batches[st["i"] % len(batches)], cfg3,
                                   generator=gen)
        st["i"] += 1

    for _ in range(WARMUP2):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAD_ITERS3):
        one()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / GRAD_ITERS3
    print(f"DCP train_step: {ms:.4f} ms/iteration over {GRAD_ITERS3}", flush=True)
    prof = profile_phase(torch, one, PROFILED3, "iteration", ms, strict=False)
    upd = {"s": st["s"]}

    def update():
        upd["s"], _ = H.guarded_update(cfg3.lr, grads, upd["s"], params, one_loss)

    ms_upd = cuda_ms(torch, update, 10)
    prof_upd = profile_phase(torch, update, PROFILED3, "update", ms_upd)
    print(f"guarded_update over {len(params)} parameter tensors ({sum(p.numel() for p in params)}"
          f" values): {ms_upd:.4f} ms, {prof_upd and prof_upd['kernels']} kernels of the "
          f"{prof and prof['kernels']} a train_step launches", flush=True)
    return launches


N_BASE5, VIEWS5, NP5, TRAIN5, B5, L5 = 4096, 10, 1024, 48, 4, 15000  # data, FMR, DCP CLI
MAXITER5 = 5  # FMR's train maxiter
FMR_CLI, DCP_CLI = [], []  # more flags for the CLIs (none: their full-width defaults)


def base_clouds(objio, out_dir):
    """Six base clouds of N_BASE5 points from seed 0, as OBJ files: three
    bare Fibonacci ellipsoids with 0.005 noise (their normals come from PCA)
    and three 64 x 64 latitude-longitude triangulated ellipsoids with faces
    (their normals come from the faces)."""
    rng = np.random.default_rng(0)
    axes = [(1.0, 0.7, 0.5), (0.9, 0.8, 0.4), (0.6, 1.0, 0.7)]
    i = np.arange(N_BASE5) + 0.5
    phi = np.arccos(1 - 2 * i / N_BASE5)
    th = np.pi * (1 + 5**0.5) * i
    fib = np.stack([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th), np.cos(phi)], -1)
    nu = nv = int(N_BASE5**0.5)
    U, W = np.meshgrid(np.linspace(0.05, np.pi - 0.05, nu),
                       np.linspace(0, 2 * np.pi, nv, endpoint=False), indexing="ij")
    sphere = np.stack([np.sin(U) * np.cos(W), np.sin(U) * np.sin(W), np.cos(U)], -1)
    faces = []
    for a in range(nu - 1):
        for b in range(nv):
            i0, i1 = a * nv + b, a * nv + (b + 1) % nv
            faces += [[i0, i0 + nv, i1], [i1, i0 + nv, i1 + nv]]
    for k, ax in enumerate(axes):
        bare = fib * ax + rng.standard_normal(fib.shape) * 0.005
        objio.write_obj(os.path.join(out_dir, f"bare_{k}.obj"), bare.astype(np.float32))
        objio.write_obj(os.path.join(out_dir, f"mesh_{k}.obj"),
                        (sphere.reshape(-1, 3) * ax[::-1]).astype(np.float32), np.array(faces))


def data_phase(torch, mods, tmp):
    """The data layer on the card (module docstring, phase 14): the six base
    clouds -> ``make_dataset.main`` at the FMR convergence protocol's
    widths (views layout, 60 pairs) -> ``generate_datasets``' 12 + 12
    batches -> ``DeviceCache`` batches equal to the streaming ``Loader``'s
    bit for bit over two epochs. Returns the dataset's directory."""
    import contextlib
    import io

    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.data import make_dataset as MK
    from a_robust_registration_loss_tpu_torch.data import objio

    G, M, IK, RS, PB = mods[:5]
    base, data = os.path.join(tmp, "base"), os.path.join(tmp, "views")
    os.makedirs(base)
    base_clouds(objio, base)
    v, _ = objio.read_obj(os.path.join(base, "bare_0.obj"))
    pts = torch.tensor(v, device=DEV)
    G.estimate_normals(pts)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G.estimate_normals(pts)
    torch.cuda.synchronize()
    ms_normals = 1e3 * (time.perf_counter() - t0)
    counts(IK, RS, PB, reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        n = MK.main(["--sources", os.path.join(base, "*.obj"), "--out", data,
                     "--n_views", str(VIEWS5), "--num_points", str(NP5),
                     "--num_sample", str(NP5), "--rot_mag", "45", "--trans_mag", "0.3",
                     "--seed", "0", "--device", DEV])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_counts(counts(IK, RS, PB), {}, 1, "make_dataset")
    check(n == 6 * VIEWS5, f"make_dataset wrote {n} pairs")
    check(objio.backend() == "native", f"objio backend {objio.backend()}")
    print(f"data: make_dataset.main, 6 base clouds of {N_BASE5} points x {VIEWS5} views at "
          f"{NP5} points, F={NP5}: {n} pairs in {dt:.2f} s ({log.getvalue().splitlines()[-1]}); "
          f"objio backend {objio.backend()}; estimate_normals of {N_BASE5} points (k-NN, "
          f"eigh of {N_BASE5} 3x3 covariances) {ms_normals:.2f} ms", flush=True)

    train, test = DS.generate_datasets(DS.DatasetConfig(
        data_path=data, layout="views", fmr=True, train_count=TRAIN5, train_batch=B5),
        device=DEV)
    check(len(train) == TRAIN5 // B5 and len(test) == 6 * VIEWS5 - TRAIN5,
          f"{len(train)} training and {len(test)} test batches")
    t0 = time.perf_counter()
    for loader in (train, test):
        cache = DS.DeviceCache(loader, DEV)
        for epoch in range(2):
            cache.set_epoch(epoch)
            loader.set_epoch(epoch)
            got, want = list(cache), list(loader)
            check(len(got) == len(want) == len(loader), "the cache's batch count")
            for a, b in zip(got, want):
                check(a.keys() == b.keys() and all(
                    a[k].device.type == DEV and torch.equal(a[k].cpu(), torch.from_numpy(b[k]))
                    for k in b), "a DeviceCache batch differs from the Loader's")
    print(f"data: generate_datasets gives {len(train)} training batches of {B5} and "
          f"{len(test)} test batches; DeviceCache batches equal the Loader's bit for bit over "
          f"2 epochs ({time.perf_counter() - t0:.2f} s)", flush=True)
    return data


class _Recorder:
    """Wraps ``LS.batch_lines`` and ``M.rigid_slots`` while it is entered:
    keeps the lines each call made (or hands ``lines`` out in their place)
    and the stage-1 counts of every rigid metric call."""

    def __init__(self, LS, M, lines=None):
        self.LS, self.M, self.given = LS, M, lines
        self.lines, self.counts = [], []

    def __enter__(self):
        self.real = self.LS.batch_lines, self.M.rigid_slots

        def batch_lines(*a, **k):
            self.lines.append(self.real[0](*a, **k) if self.given is None else self.given)
            return self.lines[-1]

        def rigid_slots(*a, **k):
            out = self.real[1](*a, **k)
            self.counts.append(np.concatenate([c.cpu().numpy() for c in out[2:]], axis=-1))
            return out

        self.LS.batch_lines, self.M.rigid_slots = batch_lines, rigid_slots
        return self

    def __exit__(self, *exc):
        self.LS.batch_lines, self.M.rigid_slots = self.real


def fmr_parity(torch, mods, cfg, model, batch, gen):
    """The card's kernel path against the CPU's plain path on one batch at
    full width: the solver's iterates; then on the card's iterates and
    lines, the loss, its gradient to the iterates and the stage-1 counts of
    each of the 3 metric calls; then end to end (each side its own solve,
    the card's lines) the loss and the gradient to every parameter."""
    from a_robust_registration_loss_tpu_torch.models.fmr import SolveRegistration
    from a_robust_registration_loss_tpu_torch.train import fmr as TF

    G, M, IK, RS, PB, LS = mods[:6]
    cpu_model = SolveRegistration(cfg.model)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    u4 = LS.draw_uniforms(B5, L5, DEV, gen)
    t0 = time.perf_counter()
    out, lines = {}, None
    for dev, m, b in ((DEV, model, batch), ("cpu", cpu_model, cpu_batch)):
        o = TF.forward(m, b, MAXITER5)
        with _Recorder(LS, M, None if lines is None else lines.cpu()) as rec:
            total, _ = LS.fmr_train_loss(o["g_series"], o["loss_ende"], b, cfg.loss, MAXITER5,
                                         u4=u4.to(dev))
        lines = rec.lines[0] if lines is None else lines
        grads = torch.autograd.grad(total, list(m.parameters()))
        out[dev] = dict(g=o["g_series"].detach().cpu(), total=float(total.detach()),
                        grad=torch.cat([g.reshape(-1) for g in grads]).cpu().double(),
                        n_singular=int(o["n_singular"]))
    g_err = float((out[DEV]["g"] - out["cpu"]["g"]).abs().max())
    e2e_loss = abs(out[DEV]["total"] - out["cpu"]["total"]) / abs(out["cpu"]["total"])
    gk, gc = out[DEV]["grad"], out["cpu"]["grad"]
    e2e_grad = float((gk - gc).norm() / gc.norm())

    # the loss on the card's iterates and lines, both sides
    same = {}
    gs = out[DEV]["g"]
    ende = torch.zeros(())
    for dev, b in ((DEV, batch), ("cpu", cpu_batch)):
        g_req = gs.to(dev).clone().requires_grad_(True)
        with _Recorder(LS, M, lines.to(dev)) as rec:
            total, parts = LS.fmr_train_loss(g_req, ende.to(dev), b, cfg.loss, MAXITER5,
                                             u4=u4.to(dev))
        (dg,) = torch.autograd.grad(total, g_req)
        same[dev] = (float(total.detach()), dg.cpu().double(), rec.counts,
                     float(parts["loss_intersection"]))
    (lk, dgk, ck, ik), (lc, dgc, cc, _) = same[DEV], same["cpu"]
    loss_err = abs(lk - lc) / abs(lc)
    grad_err = float((dgk - dgc).norm() / dgc.norm())
    counts_equal = len(ck) == len(cc) == 3 and all(np.array_equal(a, b) for a, b in zip(ck, cc))
    print(f"FMR on the card vs the CPU's plain path (B={B5} N={NP5} dim_k "
          f"{cfg.model.dim_k} L={L5}, {time.perf_counter() - t0:.1f} s): the solver's iterates "
          f"within {g_err:.3g}; on the card's iterates and lines, loss {lk:.7f} vs {lc:.7f} "
          f"(rel {loss_err:.3g}), gradient to the iterates rel L2 {grad_err:.3g}, stage-1 counts "
          f"of the 3 metric calls equal: {counts_equal} ({[int(c.sum()) for c in ck]} hits); "
          f"end to end (each side its own solve, the same lines) loss rel {e2e_loss:.3g}, "
          f"gradient to the {gk.numel()} parameter values rel L2 {e2e_grad:.3g}; n_singular "
          f"{out[DEV]['n_singular']} / {out['cpu']['n_singular']}", flush=True)
    check(ik > 0, "no usable line in the FMR metric")
    check(loss_err <= 1e-4, f"FMR loss on the same iterates: {lk} vs the CPU's {lc}")
    check(grad_err <= 5e-4, f"FMR loss gradient to the iterates: rel L2 {grad_err}")
    check(counts_equal, "FMR parity: stage-1 counts differ from the CPU's")
    # through the finite-difference Jacobian, which amplifies rounding about
    # 1 / dt = 100 times: the iterates to tests/test_torch_fmr.py's bar
    check(g_err <= 5e-4 and e2e_loss <= 1e-4 and e2e_grad <= 5e-4,
          f"FMR end to end: iterates {g_err}, loss {e2e_loss}, gradient {e2e_grad}")


def fmr_phase(torch, mods, data, tmp):
    """FMR trained from files at full width (module docstring, phase 15).
    Returns the launches of (the first training run, its eval-only
    run)."""
    import dataclasses

    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.se3 import se3
    from a_robust_registration_loss_tpu_torch.train import fmr as TF
    from a_robust_registration_loss_tpu_torch.train import harness as H

    G, M, IK, RS, PB, LS = mods[:6]
    args = ["--data_path", data, "--layout", "views", "--train_count", str(TRAIN5),
            "--batch_size", str(B5), "--n_lines", str(L5), "--seed", "0", "--device",
            DEV] + FMR_CLI
    run, full = os.path.join(tmp, "fmr_run"), os.path.join(tmp, "fmr_full")
    steps = TRAIN5 // B5
    torch.cuda.synchronize()
    counts(IK, RS, PB, reset=True)
    t0 = time.perf_counter()
    model, state, hist = TF.main(args + ["--exp_dir", run, "--epochs", "2"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts(IK, RS, PB)
    check_counts(launches, {"resample_batched": 1, "stage1_pair_pts": 3}, 2 * steps,
                 "FMR train (2 epochs of 12 steps, 12 eval batches each)")
    secs = _epoch_seconds(run)
    FP32_RUNS["fmr"] = dict(args=args + ["--epochs", "2"], hist=hist, secs=secs,
                            per_step={"resample_batched": 1, "stage1_pair_pts": 3},
                            steps=2 * steps)
    print(f"FMR train through train.fmr.main: 2 epochs of {steps} steps of B={B5} N={NP5} "
          f"L={L5} and {len(hist) and 6 * VIEWS5 - TRAIN5} eval pairs at maxiter 10: {dt:.2f} s "
          f"(CLI, data and set-up included); time/epoch_seconds {secs}; train loss "
          f"{[h['loss'] for h in hist]}; test dm {[h['test_dm'] for h in hist]}; n_singular "
          f"{[h['n_singular'] for h in hist]}; launches {launches}", flush=True)
    check(len(secs) == 2, "time/epoch_seconds is not in metrics.jsonl")
    _, _, resumed = TF.main(args + ["--exp_dir", run, "--epochs", "3"])
    _, _, uninterrupted = TF.main(args + ["--exp_dir", full, "--epochs", "3"])
    errs = [abs(h["loss"] - f["loss"]) / abs(f["loss"])
            for h, f in zip(hist + resumed, uninterrupted)]
    print(f"FMR resume: epoch {[h['epoch'] for h in resumed]} train loss "
          f"{resumed[0]['loss']:.9f}, uninterrupted {uninterrupted[2]['loss']:.9f}; train loss "
          f"rel err against the uninterrupted run by epoch {[f'{e:.3g}' for e in errs]}",
          flush=True)
    check([h["epoch"] for h in resumed] == [2], "the FMR resume did not run epoch 2 alone")
    check(len(errs) == 3 and max(errs) <= 1e-5, f"FMR train loss vs uninterrupted: {errs}")
    for h in hist + resumed + uninterrupted:
        check(all(np.isfinite(v) for v in h.values()), f"an FMR metric is not finite: {h}")
        check(h["nonfinite_steps"] == 0.0, f"an FMR step was skipped: {h}")
    check(sorted(os.listdir(os.path.join(run, "checkpoints"))) == [
        "checkpoints.json", "ckpt-0", "ckpt-1", "ckpt-2", "ckpt-best"], "FMR checkpoints")
    check(len(_epoch_seconds(run)) == 3, "FMR metrics.jsonl after the resume")

    counts(IK, RS, PB, reset=True)
    t0 = time.perf_counter()
    mean_dm = TF.main(args + ["--exp_dir", run, "--eval_only"])
    torch.cuda.synchronize()
    dt_eval = time.perf_counter() - t0
    eval_launches = counts(IK, RS, PB)
    check_counts(eval_launches, {}, 1, "FMR --eval_only")
    rows = np.loadtxt(os.path.join(run, "eval", "eval_twists.csv"), delimiter=",",
                      skiprows=1, ndmin=2)
    with open(os.path.join(run, "eval", "eval_summary.json")) as f:
        summary = json.load(f)
    check(rows.shape == (6 * VIEWS5 - TRAIN5, 12) and np.isfinite(rows).all(),
          f"eval_twists.csv {rows.shape}")
    check(np.isfinite(mean_dm) and summary == {"mean_dm": mean_dm, "n": len(rows)},
          f"eval_summary.json {summary}")
    noisy = TF.main(args + ["--exp_dir", run, "--eval_only", "--add_noise"])
    check(np.isfinite(noisy), f"--add_noise mean dm {noisy}")
    print(f"FMR --eval_only: {len(rows)} twist rows, mean dm {mean_dm:.6f} ({dt_eval:.2f} s, "
          f"CLI included; no kernel launched); with --add_noise {noisy:.6f}", flush=True)

    # the kernels on this path's own data, and the card against the CPU
    cfg = TF.FMRTrainConfig(loss=LS.LossConfig(n_lines=L5), model=model.cfg)
    train, _ = DS.generate_datasets(DS.DatasetConfig(
        data_path=data, layout="views", fmr=True, train_count=TRAIN5, train_batch=B5),
        device=DEV)
    cache = DS.DeviceCache(train, DEV)
    batch = next(iter(cache))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(8)
    with torch.no_grad():
        out = TF.forward(model, batch, MAXITER5)
        src, tar = batch["points_src_sample"], batch["points_tar_sample"]
        pred = se3.transform(out["g_series"][-1][:, None], src)
        box, c = batch["tar_box"], batch["centers"]
        r = 0.5 * torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
        u4 = LS.draw_uniforms(B5, L5, DEV, gen)
        fv = RS.prep_faces(G.bbox_face_vertices(pred), G.bbox_face_vertices(tar))
        _, h1, h2, acc, n = resample_check(torch, RS, u4, r, c, fv, "FMR")
        lines = LS.batch_lines(u4, box, c, L5, pred, tar, 0.5)
        n1, n2 = (LS._flat_neis(batch[k]) for k in
                  ("points_based_neighs_src", "points_based_neighs_tar"))
        hits = []
        for i in range(MAXITER5 - 3, MAXITER5):
            gi = out["g_series"][i]
            R_row, t = gi[:, :3, :3].transpose(-1, -2), gi[:, :3, 3]
            n1_t = (n1.reshape(B5, -1, 3) @ R_row + t[:, None, :]).reshape(n1.shape)
            deltas = (M.neighborhood_delta(n1_t), M.neighborhood_delta(n2))
            got = IK.stage1((n1_t, n2), lines, deltas, cfg.loss.kmax, **PTS)
            ref = IK.stage1_reference((n1_t, n2), lines, deltas, cfg.loss.kmax, **PTS)
            for a, b, what in zip(got, ref, ("count", "slot_idx", "d2", "recon", "slot_pts")):
                check((a is None and b is None) or torch.equal(a, b),
                      f"stage1 at FMR's iterate {i}: {what} differs from the plain version")
            hits.append(int(got[0].sum()))
    print(f"FMR's kernels on its own data: the resampler (B={B5} C={10 * L5}; mesh 1 hit by "
          f"{h1 / n:.5f}, mesh 2 by {h2 / n:.5f}, accepted {acc / n:.5f}) and stage 1 on each of "
          f"the last 3 iterates (B={B5} F={n1.shape[1]} L={L5}, hits {hits}) equal their plain "
          "versions bit for bit", flush=True)
    fmr_parity(torch, mods, cfg, model, batch, gen)

    # train_step fed from the cache: ms/step, then a 5-step profile
    st = {"s": H.adam_init(model.parameters()), "it": iter(cache)}
    step_cfg = dataclasses.replace(cfg, fit=H.FitConfig())

    def one():
        batch = next(st["it"], None)
        if batch is None:
            st["it"] = iter(cache)
            batch = next(st["it"])
        st["s"], st["m"] = TF.train_step(model, st["s"], batch, step_cfg, generator=gen)

    for _ in range(WARMUP2):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAD_ITERS3):
        one()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / GRAD_ITERS3
    print(f"FMR train_step fed from the DeviceCache: {ms:.4f} ms/step over {GRAD_ITERS3}; "
          f"n_singular of the last batch {float(st['m']['n_singular'])}", flush=True)
    st["it"] = iter(cache)  # the epoch's index copy before the window
    prof = profile_phase(torch, one, PROFILED3, "step", ms, strict=False)
    check(prof is not None and prof["htod"] == 0,
          f"FMR steps fed from the cache copied to the device: {prof}")
    # the solver's two library calls on its (B, 6, 6) matrices, alone: which
    # of the step's host waits are theirs
    H6 = torch.eye(6, device=DEV).expand(B5, 6, 6) + 0.1
    for name, fn in (("svdvals", torch.linalg.svdvals), ("inv_ex", torch.linalg.inv_ex)):
        print(f"FMR solver's {name} on (B, 6, 6), alone:", flush=True)
        profile_phase(torch, lambda: fn(H6), PROFILED3, "call", cuda_ms(torch, lambda: fn(H6), 5),
                      strict=False)

    # a NaN batch is skipped; a degenerate one freezes g at the identity
    poisoned = dict(batch)
    poisoned["points_src_sample"] = batch["points_src_sample"].clone()
    poisoned["points_src_sample"][0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    after, m = TF.train_step(model, st["s"], poisoned, step_cfg, generator=gen)
    check(float(m["nonfinite_steps"]) == 1.0, "the FMR NaN batch was not skipped")
    check(all(torch.equal(v, before[k]) for k, v in model.state_dict().items()),
          "the FMR NaN batch changed the model")
    check(all(torch.equal(a, b) for a, b in zip(after, st["s"])),
          "the FMR NaN batch changed the optimiser state")
    # the Jacobian is the target's: with every point of both clouds on one
    # line, rotation about it moves no point and H is singular
    line = torch.zeros((B5, NP5, 3), device=DEV)
    line[..., 0] = torch.linspace(-0.5, 0.5, NP5, device=DEV)
    with torch.no_grad():
        o = model(line, line, maxiter=MAXITER5)
    eye = torch.eye(4, device=DEV).expand(B5, 4, 4)
    check(int(o["n_singular"]) == B5 and torch.equal(o["g"], eye),
          f"degenerate batch: n_singular {int(o['n_singular'])}, g {o['g'][0]}")
    print(f"FMR NaN batch skipped, model and optimiser state unchanged bit for bit; a "
          f"degenerate batch (both clouds on one line) gives n_singular = {B5} and g = I",
          flush=True)
    return launches, eval_launches


def dcp_cli_phase(torch, mods, data, tmp):
    """DCP's CLI on the data phase's files at its defaults (module
    docstring, phase 16). Returns the launches of (its training run, its
    eval-only run)."""
    from a_robust_registration_loss_tpu_torch.train import dcp as TD
    from a_robust_registration_loss_tpu_torch.train import harness as H
    from a_robust_registration_loss_tpu_torch.utils import load_params_from

    G, M, IK, RS, PB = mods[:5]
    args = ["--data_path", data, "--layout", "views", "--train_count", str(TRAIN5),
            "--batch_size", str(B5), "--n_lines", str(L5), "--seed", "0", "--device",
            DEV] + DCP_CLI
    run = os.path.join(tmp, "dcp_run")
    n_test = 6 * VIEWS5 - TRAIN5
    torch.cuda.synchronize()
    counts(IK, RS, PB, reset=True)
    t0 = time.perf_counter()
    model, _, hist = TD.main(args + ["--exp_dir", run, "--epochs", "1"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts(IK, RS, PB)
    FP32_RUNS["dcp"] = dict(args=args + ["--epochs", "1"], hist=hist, secs=_epoch_seconds(run),
                            per_step={"resample_batched": 1, "stage1_pair_pts": 1},
                            steps=TRAIN5 // B5 + n_test)
    check_counts(launches, {"resample_batched": 1, "stage1_pair_pts": 1},
                 TRAIN5 // B5 + n_test, "DCP CLI train (12 steps, 12 eval batches)")
    check(all(np.isfinite(v) for v in hist[0].values()), f"a DCP CLI metric: {hist}")
    counts(IK, RS, PB, reset=True)
    t0 = time.perf_counter()
    summary = TD.main(args + ["--exp_dir", run, "--eval_only"])
    torch.cuda.synchronize()
    dt_eval = time.perf_counter() - t0
    eval_launches = counts(IK, RS, PB)
    check_counts(eval_launches, {"resample_batched": 1, "stage1_pair_pts": 1}, n_test,
                 "DCP CLI --eval_only")
    with open(os.path.join(run, "eval", "Eval.json")) as f:
        check(json.load(f) == summary, "Eval.json differs from the returned summary")
    check(all(np.isfinite(v) for v in summary.values()), f"Eval.json {summary}")
    print(f"DCP CLI (pointnet, transformer, svd, emb 512, L={L5}): 1 epoch of "
          f"{TRAIN5 // B5} steps and {n_test} eval batches {dt:.2f} s (CLI, data and set-up "
          f"included), time/epoch_seconds {_epoch_seconds(run)}, train loss "
          f"{hist[0]['loss']:.6f}; --eval_only {dt_eval:.2f} s, Eval.json loss_intersection "
          f"{summary['loss_intersection']:.6f}, r_rmse_ab {summary['r_rmse_ab']:.4f}; launches "
          f"{launches} and {eval_launches}", flush=True)

    template = {"params": model.state_dict(), "opt_state": H.adam_init(model.parameters()),
                "epoch": 0}
    loaded = load_params_from(run, template)
    start, _, none = TD.main(args + ["--exp_dir", os.path.join(tmp, "dcp_ckpt"),
                                     "--init_from_ckpt", run, "--epochs", "0"])
    same = lambda a, b: a.keys() == b.keys() and all(torch.equal(v, b[k]) for k, v in a.items())
    check(none == [] and same(start.state_dict(), loaded),
          "--init_from_ckpt: the parameters before the first step differ from the loaded ones")
    pth = os.path.join(tmp, "dcp_ref.pth")
    first = model.state_dict()
    torch.save({"state_dict": {f"module.{k}": v for k, v in first.items()}, "epoch": 1}, pth)
    start, _, _ = TD.main(args + ["--exp_dir", os.path.join(tmp, "dcp_torch"),
                                  "--init_from_torch", pth, "--epochs", "0"])
    check(same(start.state_dict(), first),
          "--init_from_torch: the parameters differ from the saved state_dict's")
    print("DCP CLI --init_from_ckpt: the parameters before the first step equal the loaded "
          "best checkpoint's; --init_from_torch (module. prefix, {'state_dict': ...}, an int "
          "entry beside it): equal to the saved model's", flush=True)
    return launches, eval_launches


L_RPM = 10000  # RPM-Net's lines a sample
RPM_CLI = []  # more flags for RPM-Net's CLI (none: its full-width defaults)
RPM_STEPS = {  # launches by kind of step: 2 registration iterations in training, 5 in eval
    "train": {"resample_batched": 1, "stage1_pair_pts": 2, "gather_fwd": 4},
    "eval": {"gather_fwd": 10},
    "pretrain": {"gather_fwd": 2},
    "artifact": {"gather_fwd": 10},
}
RPM_RADIUS, RPM_NS = 0.3, 64  # RPMNetConfig's ball


class _StepCounts:
    """Wraps ``train.rpmnet``'s step functions, and the scanned epoch's
    steps (``harness._Scan``, each replay of a step's graphs), while
    entered: each call's launches must equal ``RPM_STEPS`` of its kind (0
    of every other kernel, the gather's backward and stage 1's other
    instantiations among them); counts the calls and adds up the launches
    by kind."""

    NAMES = {"train_step": "train", "eval_step": "eval", "pretrain_step": "pretrain",
             "artifact_fn": "artifact"}

    def __init__(self, TR, IK, RS, PB):
        from a_robust_registration_loss_tpu_torch.train import harness as H

        self.TR, self.H, self.mods = TR, H, (IK, RS, PB)
        self.calls = {k: 0 for k in self.NAMES.values()}
        self.totals = {k: {} for k in self.NAMES.values()}

    def _count(self, kind, fn, *a, **k):
        before = counts(*self.mods)
        out = fn(*a, **k)
        diff = {n: c - before[n] for n, c in counts(*self.mods).items()}
        check_counts(diff, RPM_STEPS[kind], 1, f"an RPM-Net {kind} step")
        self.calls[kind] += 1
        for n, c in diff.items():
            self.totals[kind][n] = self.totals[kind].get(n, 0) + c
        return out

    def __enter__(self):
        self.real = {name: getattr(self.TR, name) for name in self.NAMES}
        for name, kind in self.NAMES.items():
            setattr(self.TR, name, lambda *a, fn=self.real[name], kind=kind, **k:
                    self._count(kind, fn, *a, **k))
        self.scan = self.H._Scan.__call__

        def scanned(scan, *a, **k):  # the kind from the split: lines, an update
            kind = ("eval" if scan.split.update is None
                    else "train" if scan.split.lines is not None else "pretrain")
            return self._count(kind, self.scan, scan, *a, **k)

        self.H._Scan.__call__ = scanned
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.TR, name, fn)
        self.H._Scan.__call__ = self.scan


def knife_edge_rows(torch, xyz, radius):
    """(B, N) bool on the CPU: the rows of a self-excluding ball query of xyz
    that hold a pair whose float64 d^2 lies within 1e-6 r^2 of r^2, where
    two roundings of the inner-product expansion may disagree."""
    p = xyz.detach().cpu().double()
    d2 = torch.cdist(p, p) ** 2
    edge = (d2 - radius**2).abs() <= 1e-6 * radius**2
    edge &= ~torch.eye(p.shape[1], dtype=torch.bool)[None]
    return edge.any(-1)


class _Handed:
    """Wraps ``models.rpmnet.query_ball_point_excl`` while entered: records
    the indices of every call, or hands ``given`` out in their place, in
    call order."""

    def __init__(self, RM, given=None):
        self.RM, self.given, self.seen = RM, None if given is None else iter(given), []

    def __enter__(self):
        self.real = self.RM.query_ball_point_excl

        def query(*a, **k):
            self.seen.append(self.real(*a, **k) if self.given is None else next(self.given))
            return self.seen[-1]

        self.RM.query_ball_point_excl = query
        return self

    def __exit__(self, *exc):
        self.RM.query_ball_point_excl = self.real


def rpm_parity(torch, mods, cfg, model, batch, gen):
    """One training step on the card against the CPU's plain path at full
    width, the card's lines and ball indices on both sides. The loss on the
    card's transforms and Sinkhorn matrices: within 1e-4 relative, stage-1
    counts equal in every iteration, its gradient there within 5e-4
    relative L2. The network's backward from that gradient to every
    parameter: within 5e-4 relative L2 of the CPU's or, where the Kabsch
    SVD amplifies rounding, no farther from the network's float64 backward
    (on the CPU) than twice the CPU's fp32 distance to it. Each side's own
    forward: the transforms within 1e-4 and the Sinkhorn matrices within
    1e-6 of the CPU's, and the loss on them within 2e-3 relative (fp32
    rounding moves the transforms, which moves a few stage-1 hits). The
    card's resampler and stage 1 on the inputs this step gave them:
    ``rpm_kernels``. Prints the Kabsch covariances' singular values and the
    SVD gradient's largest 1 / (s_i^2 - s_j^2). Returns the errors."""
    from a_robust_registration_loss_tpu_torch.models import rpmnet as RM
    from a_robust_registration_loss_tpu_torch.train import rpmnet as TR

    G, M, IK, RS, PB, LS = mods[:6]
    GK = RM.GK
    n_iter = cfg.num_train_reg_iter
    rel = lambda a, b: float((a - b).norm() / b.norm())
    flat = lambda xs: torch.cat([x.reshape(-1) for x in xs]).cpu().double()
    u4 = LS.draw_uniforms(B5, L_RPM, DEV, gen)
    t0 = time.perf_counter()
    svals = []
    real_svd = torch.linalg.svd

    def svd(x, *a, **k):  # the card's Kabsch covariances' singular values
        svals.append(torch.linalg.svdvals(x.detach()).cpu())
        return real_svd(x, *a, **k)

    def network(m, b, given=None):
        """m's outputs (transforms then Sinkhorn matrices) and the ball
        indices it took (given ones, or its own)."""
        with _Handed(RM, given) as hand:
            transforms, ep = TR.forward(m, b, n_iter)
        return list(transforms) + list(ep["perm_matrices"]), hand.seen

    def loss(outs, b, lines=None):
        """(total, the gradient at outs, stage-1 counts, the lines) of the
        loss on outs as leaves."""
        leaves = [o.detach().requires_grad_(True) for o in outs]
        with _Recorder(LS, M, lines) as rec:
            losses, _ = LS.rpm_cal_loss(leaves[:n_iter], leaves[n_iter:], b, cfg.loss,
                                        u4=u4.to(leaves[0].device))
        total = LS.rpm_total_loss(losses)
        check(float(losses["loss_intersection"].detach()) > 0, "no usable line in RPM-Net's loss")
        return float(total.detach()), torch.autograd.grad(total, leaves), rec.counts, rec.lines[0]

    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    torch.linalg.svd = svd
    try:
        outs_k, idx = network(model, batch)
    finally:
        torch.linalg.svd = real_svd
    idx = [i.cpu() for i in idx]
    total_k, up_k, counts_k, lines = loss(outs_k, batch)
    rpm_kernels(torch, mods, cfg, batch, [o.detach() for o in outs_k[:n_iter]], u4, lines,
                counts_k)
    lines = lines.cpu()
    total_c, up_c, counts_c, _ = loss([o.detach().cpu() for o in outs_k], cpu_batch, lines)
    loss_err = abs(total_k - total_c) / abs(total_c)
    up_err = rel(flat(up_k), flat(up_c))
    counts_equal = len(counts_k) == len(counts_c) == n_iter and all(
        np.array_equal(a, b) for a, b in zip(counts_k, counts_c))

    # the network's backward from the card's upstream gradient: card, CPU
    # fp32, CPU float64
    cpu_model = RM.RPMNetEarlyFusion(cfg.model)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    outs_c, _ = network(cpu_model, cpu_batch, idx)
    m64 = RM.RPMNetEarlyFusion(cfg.model).double()
    m64.load_state_dict({k: v.double() for k, v in cpu_model.state_dict().items()})
    b64 = {k: (v.double() if v.is_floating_point() else v) for k, v in cpu_batch.items()}
    real_gather = GK.gather_rows
    GK.gather_rows = GK.gather_rows_reference  # the plain version takes float64
    try:
        outs_64, _ = network(m64, b64, idx)
    finally:
        GK.gather_rows = real_gather
    g = {}
    for name, m, outs in (("card", model, outs_k), ("cpu", cpu_model, outs_c),
                          ("f64", m64, outs_64)):
        up = [u.to(outs[0].device, outs[0].dtype) for u in up_k]
        g[name] = flat(torch.autograd.grad(outs, list(m.parameters()), up))
    e_kc, e_k64, e_c64 = rel(g["card"], g["cpu"]), rel(g["card"], g["f64"]), rel(g["cpu"],
                                                                                  g["f64"])
    out_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                  for a, b in zip(outs_k[:n_iter], outs_c[:n_iter]))
    perm_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                   for a, b in zip(outs_k[n_iter:], outs_c[n_iter:]))
    # each side's own forward and loss (the same lines and ball indices)
    own_c, _, own_counts, _ = loss(outs_c, cpu_batch, lines)
    own_hits = [int((a != b).sum()) for a, b in zip(counts_k, own_counts)]
    own_err = abs(total_k - own_c) / abs(own_c)
    sv = torch.stack(svals)  # (iterations, B, 3)
    gaps = torch.stack([sv[..., 0] ** 2 - sv[..., 1] ** 2, sv[..., 1] ** 2 - sv[..., 2] ** 2])
    print(f"RPM-Net on the card vs the CPU's plain path (B={B5} N={NP5} feat_dim "
          f"{cfg.model.feat_dim} k={cfg.model.num_neighbors} L={L_RPM}, {n_iter} iterations, "
          f"the card's lines and ball indices on both sides, {time.perf_counter() - t0:.1f} s): "
          f"on the card's transforms and Sinkhorn matrices, loss {total_k:.7f} vs "
          f"{total_c:.7f} (rel {loss_err:.3g}), stage-1 counts equal in every iteration: "
          f"{counts_equal} ({[int(c.sum()) for c in counts_k]} hits), its gradient there rel "
          f"L2 {up_err:.3g}; the network's backward from that gradient to the "
          f"{g['card'].numel()} parameter values rel L2 {e_kc:.3g} (card vs CPU), {e_k64:.3g} "
          f"(card vs float64), {e_c64:.3g} (CPU vs float64); each side's own forward: "
          f"transforms within {out_err:.3g}, Sinkhorn matrices within {perm_err:.3g}, loss "
          f"{own_c:.7f} (rel {own_err:.3g}), {own_hits} stage-1 counts "
          f"differ; Kabsch covariances' singular values by iteration "
          f"{np.round(sv.numpy(), 6).tolist()}, the SVD gradient's largest 1 / (s_i^2 - "
          f"s_j^2) {float(1 / gaps.abs().min()):.4g}", flush=True)
    check(loss_err <= 1e-4, f"RPM-Net loss on the card's outputs: {total_k} vs the CPU's "
          f"{total_c}")
    check(out_err <= 1e-4, f"RPM-Net transforms: the card's within {out_err} of the CPU's")
    check(perm_err <= 1e-6, f"RPM-Net Sinkhorn matrices: the card's within {perm_err} of the "
          "CPU's")
    check(own_err <= 2e-3, f"RPM-Net loss on each side's own forward: rel {own_err}")
    check(counts_equal, "RPM-Net parity: stage-1 counts differ from the CPU's")
    check(up_err <= 5e-4, f"RPM-Net loss gradient at the network's outputs: rel L2 {up_err}")
    check(e_kc <= 5e-4 or e_k64 <= 2 * e_c64,
          f"RPM-Net network gradient: card vs CPU {e_kc}, card vs float64 {e_k64}, CPU vs "
          f"float64 {e_c64}")
    return dict(loss_rel=loss_err, upstream_rel=up_err, grad_rel=e_kc, grad_rel_f64=e_k64,
                cpu_rel_f64=e_c64, transforms_abs=out_err, perms_abs=perm_err,
                own_loss_rel=own_err, own_counts_differ=own_hits)


def rpm_kernels(torch, mods, cfg, batch, transforms, u4, lines, counts_k):
    """RPM-Net's kernels on the inputs its loss gave them in one card step:
    the batched resampler (``u4``, the full diagonal, the source moved by
    iteration 0's transform) against its plain version bit for bit, the
    loss's ``lines`` equal to those the plain version's candidates give,
    then stage 1 on each iteration's moved source against its plain version
    bit for bit, its counts equal to the loss's ``counts_k``."""
    G, M, IK, RS, _, LS = mods[:6]
    src, tar = batch["points_src_sample"][..., :3], batch["points_tar_sample"]
    box, c = batch["tar_box"], batch["centers"]
    r = torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
    fv = RS.prep_faces(G.bbox_face_vertices(LS.se3.rt_transform(transforms[0], src)),
                       G.bbox_face_vertices(tar))
    _, h1, h2, acc, n = resample_check(torch, RS, u4, r, c, fv, "RPM-Net")
    cand, ok = RS.sample_and_hit_reference(u4, r, c, fv)
    check(torch.equal(LS.LN._fill_first_n_gather(cand, ok, L_RPM), lines),
          "RPM-Net's lines differ from those of the resampler's plain version")
    n1, n2 = (LS._flat_neis(batch[k]) for k in
              ("points_based_neighs_src", "points_based_neighs_tar"))
    hits = []
    for i, g in enumerate(transforms):
        R_row, t = g[:, :3, :3].transpose(-1, -2), g[:, :3, 3]
        n1_t = (n1.reshape(B5, -1, 3) @ R_row + t[:, None, :]).reshape(n1.shape)
        deltas = (M.neighborhood_delta(n1_t), M.neighborhood_delta(n2))
        got = IK.stage1((n1_t, n2), lines, deltas, cfg.loss.kmax, **PTS)
        ref = IK.stage1_reference((n1_t, n2), lines, deltas, cfg.loss.kmax, **PTS)
        for a, b, what in zip(got, ref, ("count", "slot_idx", "d2", "recon", "slot_pts")):
            check((a is None and b is None) or torch.equal(a, b),
                  f"stage1 at RPM-Net's iteration {i}: {what} differs from the plain version")
        count = torch.cat([got[0][..., 0, :], got[0][..., 1, :]], dim=-1).cpu().numpy()
        check(np.array_equal(count, counts_k[i]),
              f"stage1 at RPM-Net's iteration {i}: counts differ from the loss's")
        hits.append(int(got[0].sum()))
    print(f"RPM-Net's kernels on its own step: the resampler (B={B5} C={u4.shape[-1]}, radius "
          f"the full diagonal, the source moved by iteration 0; mesh 1 hit by {h1 / n:.5f}, "
          f"mesh 2 by {h2 / n:.5f}, accepted {acc / n:.5f}) equals its plain version bit for "
          f"bit and gives the loss's lines; stage 1 on each of the {len(transforms)} "
          f"iterations (B={B5} F={n1.shape[1]} L={lines.shape[1]}, hits {hits}) equals its "
          "plain version bit for bit and gives the loss's counts", flush=True)


def rpm_grouping_phase(torch, mods, data):
    """RPM-Net's grouping on a training batch of the data phase's files
    (module docstring, phase 17), before any other phase traces (after
    other traces the tracer may lose a short kernel's records in every
    window): the ball query on the
    card against the CPU, equal off the float64 knife edge, then the gather
    on its indices against ``gather_rows_reference`` and
    ``take_along_dim`` bit for bit, with both directions' times. Returns
    the gather's fields {"fwd": ..., "bwd": ...}."""
    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.models import rpmnet as RM

    GK = mods[6]
    train, _ = DS.generate_datasets(DS.DatasetConfig(
        data_path=data, layout="views", train_count=TRAIN5, train_batch=B5), device=DEV)
    batch = next(iter(DS.DeviceCache(train, DEV)))
    # RPM-Net's own ball query on a real batch: card against CPU, then the
    # gather on its indices against its plain version, with its times
    src, nsrc = batch["points_src_sample"], batch["normals_src"]
    itself = torch.arange(NP5, device=DEV).expand(B5, NP5)
    idx = RM.query_ball_point_excl(RPM_RADIUS, RPM_NS, src, src, itself)
    idx_cpu = RM.query_ball_point_excl(RPM_RADIUS, RPM_NS, src.cpu(), src.cpu(), itself.cpu())
    differ = idx.cpu() != idx_cpu
    edge = knife_edge_rows(torch, src, RPM_RADIUS)
    rows = differ.any(-1)
    check(not bool((rows & ~edge).any()),
          "RPM-Net ball query: the card and the CPU differ off the knife edge")
    inball = float((idx != itself[..., None]).float().sum(-1).mean())
    table = torch.cat([src, nsrc], dim=-1)
    flat = idx.reshape(B5, NP5 * RPM_NS)
    g = torch.randn((B5, flat.shape[1], 6), generator=gen_on(torch, 17), device=DEV)
    ef, eb = gather_check(torch, GK, table, flat, g, "RPM-Net's ball query")
    gtimes = gather_times(torch, GK, table, flat, g)
    gtimes["fwd"]["err"], gtimes["bwd"]["err"] = ef, eb
    fwd = gtimes["fwd"]
    db = 1e3 * fwd["nbytes"] / PEAK_BYTES
    print(f"RPM-Net's ball query on a training batch (radius {RPM_RADIUS}, {RPM_NS} "
          f"neighbours, {inball:.1f} in the ball on average): card vs CPU {int(differ.sum())} "
          f"differing entries in {int(rows.sum())} rows, all among the {int(edge.sum())} rows "
          f"with a knife-edge pair; the gather on its indices ({fwd['shape']}) equals "
          f"gather_rows_reference and take_along_dim bit for bit: kernel {fwd['ms']:.4f} ms, "
          f"call {fwd['call_ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, take_along_dim "
          f"{fwd['library_ms']:.4f} ms, bound {db:.5f} ms by bytes ({db / fwd['ms']:.1%} of it "
          f"reached)", flush=True)
    return gtimes, (table, flat, g)


def late_gather_phase(torch, GK, early, inputs):
    """RPM-Net's gather on its ball query timed again after every other
    phase, as ``rpm_grouping_phase`` timed it first: ``kernel_ms`` must see
    every launch in a window here too (``prime``)."""
    late = gather_times(torch, GK, *inputs)
    print(f"RPM-Net's gather on its ball query, timed again after the last phase: forward "
          f"{late['fwd']['ms']:.4f} ms (first {early['fwd']['ms']:.4f}), backward "
          f"{late['bwd']['ms']:.4f} ms{split_text(late['bwd'])} (first "
          f"{early['bwd']['ms']:.4f}); every launch seen in a window", flush=True)
    return late


def rpm_phase(torch, mods, data, tmp, rate):
    """RPM-Net trained from files at full width (module docstring, phase
    17). Returns ({path: launches} of the first training run by kind of
    step and of its eval-only run, the step's measured numbers)."""
    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.models import rpmnet as RM
    from a_robust_registration_loss_tpu_torch.models.common import TorchGroupNorm
    from a_robust_registration_loss_tpu_torch.train import harness as H
    from a_robust_registration_loss_tpu_torch.train import rpmnet as TR
    from a_robust_registration_loss_tpu_torch.utils import CheckPointManager, load_params_from

    G, M, IK, RS, PB, LS, GK = mods[:7]
    args = ["--data_path", data, "--layout", "views", "--train_count", str(TRAIN5),
            "--batch_size", str(B5), "--n_lines", str(L_RPM), "--pretrain_epochs", "1",
            "--seed", "0", "--device", DEV] + RPM_CLI
    run, full = os.path.join(tmp, "rpm_run"), os.path.join(tmp, "rpm_full")
    steps, n_test = TRAIN5 // B5, 6 * VIEWS5 - TRAIN5
    torch.cuda.synchronize()
    counts(IK, RS, PB, reset=True)
    t0 = time.perf_counter()
    with _StepCounts(TR, IK, RS, PB) as sc:
        model, state, hist = TR.main(args + ["--exp_dir", run, "--epochs", "2"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts(IK, RS, PB)
    check(sc.calls == {"train": 2 * steps, "eval": 2 * n_test, "pretrain": steps,
                       "artifact": 1}, f"RPM-Net steps by kind: {sc.calls}")
    by_kind = {n: sum(t.get(n, 0) for t in sc.totals.values()) for n in launches}
    check(by_kind == launches, f"RPM-Net launches outside its steps: {launches} vs {by_kind}")
    paths = {"rpm_pretrain": sc.totals["pretrain"],
             "rpm_train": {n: launches[n] - sc.totals["pretrain"][n] for n in launches}}
    cfg = TR.RPMTrainConfig(loss=LS.LossConfig(n_lines=L_RPM), model=model.cfg)
    secs = _epoch_seconds(run)
    FP32_RUNS["rpm"] = dict(args=args + ["--epochs", "2"], hist=hist, secs=secs,
                            calls=dict(sc.calls))
    print(f"RPM-Net train through train.rpmnet.main: 1 pretrain epoch and 2 epochs of {steps} "
          f"steps of B={B5} N={NP5} L={L_RPM} (feat_dim {cfg.model.feat_dim}, k="
          f"{cfg.model.num_neighbors}, radius {cfg.model.radius}, {cfg.model.num_sk_iter} "
          f"Sinkhorn iterations, {sum(p.numel() for p in model.parameters())} parameters) and "
          f"{n_test} eval pairs at 5 iterations: {dt:.2f} s (CLI, data and set-up included); "
          f"time/epoch_seconds {secs} (pretrain {_epoch_seconds(os.path.join(run, 'pretrain'))})"
          f"; train loss {[h['loss'] for h in hist]}; test loss_gt "
          f"{[h['test_loss'] for h in hist]}; steps {sc.calls}; launches by kind of step "
          f"{ {k: {n: c for n, c in v.items() if c} for k, v in sc.totals.items()} }",
          flush=True)
    check(len(secs) == 2, "time/epoch_seconds is not in metrics.jsonl")
    check(int(state.adam.count) == 3 * steps and int(state.count) == 2 * steps,
          f"RPM-Net Adam count {int(state.adam.count)}, schedule count {int(state.count)}")

    # the state a resume loads equals the state saved, bit for bit
    template = {"params": TR.init_model(cfg, 99, DEV).state_dict(),
                "opt_state": H.scheduled_adam_init(model.parameters()), "epoch": 0}
    loaded, _ = CheckPointManager(os.path.join(run, "checkpoints")).load(template)
    saved = model.state_dict()
    check(int(loaded["epoch"]) == 1 and all(torch.equal(v, saved[k])
                                            for k, v in loaded["params"].items()),
          "RPM-Net: the checkpoint's parameters differ from the trained model's")
    check(all(torch.equal(a, b) for a, b in zip(loaded["opt_state"].adam + (
        loaded["opt_state"].count,), state.adam + (state.count,))),
          "RPM-Net: the checkpoint's optimiser state differs from the trained one")
    _, _, resumed = TR.main(args + ["--exp_dir", run, "--epochs", "3"])
    _, _, uninterrupted = TR.main(args + ["--exp_dir", full, "--epochs", "3"])
    errs = [abs(h["loss"] - f["loss"]) / abs(f["loss"])
            for h, f in zip(hist + resumed, uninterrupted)]
    print(f"RPM-Net resume: epoch {[h['epoch'] for h in resumed]} train loss "
          f"{resumed[0]['loss']:.9f}, uninterrupted {uninterrupted[2]['loss']:.9f}; train loss "
          f"rel err against the uninterrupted run by epoch {[f'{e:.3g}' for e in errs]}",
          flush=True)
    check([h["epoch"] for h in resumed] == [2], "the RPM-Net resume did not run epoch 2 alone")
    check(len(errs) == 3 and max(errs) <= 1e-5, f"RPM-Net train loss vs uninterrupted: {errs}")
    for h in hist + resumed + uninterrupted:
        check(all(np.isfinite(v) for v in h.values()), f"an RPM-Net metric is not finite: {h}")
        check(h["nonfinite_steps"] == 0.0, f"an RPM-Net step was skipped: {h}")

    counts(IK, RS, PB, reset=True)
    t0 = time.perf_counter()
    summary = TR.main(args + ["--exp_dir", run, "--eval_only"])
    torch.cuda.synchronize()
    dt_eval = time.perf_counter() - t0
    paths["rpm_eval_only"] = counts(IK, RS, PB)
    check_counts(paths["rpm_eval_only"], RPM_STEPS["eval"], n_test, "RPM-Net --eval_only")
    out = os.path.join(run, "eval")
    with open(os.path.join(out, "Val.json")) as f:
        check(json.load(f) == summary and all(np.isfinite(list(summary.values()))),
              f"Val.json {summary}")
    # the .bin transforms: the model of the latest checkpoint (epoch 2) on the test pairs
    state2, _ = CheckPointManager(os.path.join(run, "checkpoints")).load(template)
    epoch = int(state2["epoch"])
    check(epoch == 2, f"the latest RPM-Net checkpoint is epoch {epoch}")
    evaluated = TR.init_model(cfg, 0, DEV)
    evaluated.load_state_dict(state2["params"])
    _, test = DS.generate_datasets(DS.DatasetConfig(
        data_path=data, layout="views", train_count=TRAIN5, train_batch=B5), device=DEV)
    worst = 0.0
    with torch.no_grad():
        for i, b in enumerate(test):
            b = {k: torch.as_tensor(v, device=DEV) for k, v in b.items()}
            tf = TR.forward(evaluated, b, cfg.num_eval_reg_iter)[0][-1][0].cpu().numpy()
            binary = np.fromfile(os.path.join(out, f"{epoch}_pred_src_{i}.bin"), np.float32)
            want = np.concatenate([tf[:, :3].T, tf[:, 3:]], axis=1).reshape(-1)
            worst = max(worst, float(np.abs(binary - want).max()))
            for part in ("src", "pred_src", "tar", "gt_src"):
                check(os.path.exists(os.path.join(out, f"pair{i}_{part}.obj")),
                      f"RPM-Net eval: pair{i}_{part}.obj is missing")
    check(i == n_test - 1 and worst <= 1e-5,
          f"RPM-Net eval: {i + 1} pairs, the .bin transforms (R transposed) within {worst} of "
          "the model's")
    print(f"RPM-Net --eval_only: {n_test} pairs ({dt_eval:.2f} s, CLI included), Val.json sums "
          f"{summary}; the {n_test} {epoch}_pred_src_*.bin transforms (R transposed) within "
          f"{worst:.3g} of the checkpoint's model on the card; launches {paths['rpm_eval_only']}",
          flush=True)

    # the initialisations
    loaded_best = load_params_from(run, template)
    start, _, none = TR.main(args + ["--exp_dir", os.path.join(tmp, "rpm_ckpt"),
                                     "--init_from_ckpt", run, "--epochs", "0",
                                     "--pretrain_epochs", "0"])
    same = lambda a, b: a.keys() == b.keys() and all(torch.equal(v, b[k]) for k, v in a.items())
    check(none == [] and same(start.state_dict(), loaded_best),
          "RPM-Net --init_from_ckpt: the parameters before the first step differ from the "
          "loaded ones")
    pth = os.path.join(tmp, "rpm_ref.pth")
    ref = {k: v.cpu().clone() for k, v in saved.items()}
    for k in ("weights_net.postpool.6.weight", "weights_net.postpool.6.bias"):
        ref[k] = torch.cat([ref[k], torch.ones((3,) + ref[k].shape[1:])])  # weights_dim 3
    torch.save({"state_dict": {f"module.{k}": v for k, v in ref.items()}, "epoch": 1}, pth)
    start, _, _ = TR.main(args + ["--exp_dir", os.path.join(tmp, "rpm_torch"),
                                  "--init_from_torch", pth, "--epochs", "0",
                                  "--pretrain_epochs", "0"])
    check(same(start.state_dict(), saved),
          "RPM-Net --init_from_torch: the parameters differ from the saved model's")
    print("RPM-Net --init_from_ckpt: the parameters before the first step equal the loaded "
          "best checkpoint's; --init_from_torch (a reference-layout .pth: module. prefix, "
          "{'state_dict': ...}, the annealing net's last layer with 2 + 3 outputs): equal to "
          "the saved model's", flush=True)

    train, _ = DS.generate_datasets(DS.DatasetConfig(
        data_path=data, layout="views", train_count=TRAIN5, train_batch=B5), device=DEV)
    cache = DS.DeviceCache(train, DEV)
    batch = next(iter(cache))
    gen = gen_on(torch, 8)
    parity = rpm_parity(torch, mods, cfg, model, batch, gen)

    # train_step fed from the cache: ms/step, peak memory, then a 5-step profile
    st = {"s": H.scheduled_adam_init(model.parameters()), "it": iter(cache)}

    def one():
        b = next(st["it"], None)
        if b is None:
            st["it"] = iter(cache)
            b = next(st["it"])
        st["s"], st["m"] = TR.train_step(model, st["s"], b, cfg, generator=gen)

    for _ in range(WARMUP2):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAD_ITERS3):
        one()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / GRAD_ITERS3
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"RPM-Net train_step fed from the DeviceCache: {ms:.4f} ms/step over {GRAD_ITERS3}; "
          f"peak memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above the "
          f"{base / 2**20:.1f} MiB held before the step)", flush=True)
    st["it"] = iter(cache)  # the epoch's index copy before the window
    with _Spans(model, TorchGroupNorm, "rpm.group_norm"):
        prof = profile_phase(torch, one, PROFILED3, "step", ms, strict=False,
                             label="rpm.group_norm")
    check(prof is not None and prof["htod"] == 0,
          f"RPM-Net steps fed from the cache copied to the device: {prof}")
    gn_ms, gn_calls = groupnorm_ms(torch, model, one)
    gn_traced, busy = prof["labelled_ms"], prof["busy_ms"]
    check(gn_traced > 0, "the step's trace holds no GroupNorm kernel")
    print(f"RPM-Net's GroupNorm passes: {gn_calls} a step; forward and backward in the "
          f"profiled steps' own trace {gn_traced:.4f} ms a step = {gn_traced / busy:.1%} of "
          f"the step's {busy:.4f} ms of device time; each timed alone at its shape "
          f"{gn_ms:.4f} ms a step = {gn_ms / busy:.1%}", flush=True)
    # the step's library calls that may wait for the card, alone
    H3 = torch.eye(3, device=DEV).expand(B5, 3, 3) + 0.1
    for name, fn in (("svd", torch.linalg.svd), ("det", torch.linalg.det)):
        print(f"RPM-Net Kabsch's {name} on (B, 3, 3), alone:", flush=True)
        profile_phase(torch, lambda: fn(H3), PROFILED3, "call", cuda_ms(torch, lambda: fn(H3), 5),
                      strict=False)

    # a NaN batch is skipped, the model and the state unchanged
    poisoned = dict(batch)
    poisoned["points_src_sample"] = batch["points_src_sample"].clone()
    poisoned["points_src_sample"][0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    after, m = TR.train_step(model, st["s"], poisoned, cfg, generator=gen)
    check(float(m["nonfinite_steps"]) == 1.0, "the RPM-Net NaN batch was not skipped")
    check(all(torch.equal(v, before[k]) for k, v in model.state_dict().items()),
          "the RPM-Net NaN batch changed the model")
    check(all(torch.equal(a, b) for a, b in zip(after.adam + (after.count,),
                                                st["s"].adam + (st["s"].count,))),
          "the RPM-Net NaN batch changed the optimiser state")
    print("RPM-Net NaN batch skipped, model and optimiser state unchanged bit for bit",
          flush=True)
    return paths, dict(parity, ms_step=ms, peak_mib=peak / 2**20, profile=prof,
                       epoch_seconds=secs, groupnorm_ms=gn_ms, groupnorm_traced_ms=gn_traced)

# the bf16 phases (module docstring, phase 18). The card's bf16 step
# against the CPU's bf16 step on the
# same weights, batch, lines (and RPM-Net's ball indices), each side its own
# forward: bf16 keeps 8 bits of mantissa and the two sides' products sum in
# other orders, so a rounding falls the other way now and then and the
# difference grows with depth, as the port against the JAX package on the
# CPU shows (tests/test_torch_mixed_precision.py: transforms 0.002 to 0.02
# apart): transforms within 0.05 (the JAX package's own bf16-to-fp32 bar for
# DCP), the loss within 5% relative, at most 2% of the stage-1 counts moved;
# on the card's outputs the fp32 metric on both sides: within 1e-4
# relative, at most 1e-4 of the counts moved, not none: on FMR's
# bf16-trained iterates a hit can lie a knife edge apart, where the glue's
# fp32 transform of the neighbourhoods rounds differently on the two devices
# (PERF.md section 6)
BF16_CPU = dict(transforms=0.05, loss=0.05, counts=0.02, same_loss=1e-4, same_counts=1e-4)
# the card's bf16 forward against its fp32 forward on the same weights: the
# JAX package's TestMixedPrecision bars (transforms atol, loss_ende rtol)
BF16_FP32 = {"dcp": (0.05, None), "fmr": (0.25, 0.1), "rpm": (0.12, None)}
BF16_TRAIN_REL = 0.10  # each epoch's train loss, bf16 against fp32 (DCP, RPM-Net)
FP32_RUNS = {}  # the fp32 phases' first training runs, by trainer: args, hist, secs


class _Adapter:
    """What the bf16 phase needs of one trainer: its step module, config,
    data, optimiser state, forward and loss."""

    def __init__(self, torch, mods, name, model, data):
        from a_robust_registration_loss_tpu_torch.data import dataset as DS
        from a_robust_registration_loss_tpu_torch.models import rpmnet as RM
        from a_robust_registration_loss_tpu_torch.train import dcp as TD
        from a_robust_registration_loss_tpu_torch.train import fmr as TF
        from a_robust_registration_loss_tpu_torch.train import harness as H
        from a_robust_registration_loss_tpu_torch.train import rpmnet as TR

        self.torch, self.mods, self.name, self.RM, self.H = torch, mods, name, RM, H
        LS = mods[5]
        self.T = {"dcp": TD, "fmr": TF, "rpm": TR}[name]
        n_lines = L_RPM if name == "rpm" else L5
        cfg_cls = {"dcp": TD.DCPTrainConfig, "fmr": TF.FMRTrainConfig,
                   "rpm": TR.RPMTrainConfig}[name]
        self.cfg = cfg_cls(loss=LS.LossConfig(n_lines=n_lines), model=model.cfg)
        self.n_lines = n_lines
        train, _ = DS.generate_datasets(DS.DatasetConfig(
            data_path=data, layout="views", train_count=TRAIN5, train_batch=B5,
            dcp=name == "dcp", fmr=name == "fmr"), device=DEV)
        self.cache = DS.DeviceCache(train, DEV)

    def model(self, state_dict, dtype, device=None):
        """A model of this config in ``dtype`` holding ``state_dict``, on the
        card unless ``device`` says otherwise."""
        import dataclasses

        device = device or DEV

        cfg = dataclasses.replace(self.cfg, model=dataclasses.replace(self.cfg.model,
                                                                      dtype=dtype))
        m = self.T.init_model(cfg, 0, device)
        m.load_state_dict({k: v.to(device) for k, v in state_dict.items()})
        return m

    def state(self, m):
        init = self.H.scheduled_adam_init if self.name == "rpm" else self.H.adam_init
        return init(m.parameters())

    def forward(self, m, b, given=None):
        """(outputs, the ball indices taken) of one forward."""
        with self.torch.no_grad():
            if self.name == "dcp":
                return list(self.T.forward(m, b)), []
            if self.name == "fmr":
                o = self.T.forward(m, b, MAXITER5)
                return [o["g_series"], o["loss_ende"]], []
            with _Handed(self.RM, given) as hand:
                tfs, ep = self.T.forward(m, b, self.cfg.num_train_reg_iter)
            return list(tfs) + list(ep["perm_matrices"]), hand.seen

    def transforms(self, outs):
        """The outputs held to the bars: R and t, g, or the transforms."""
        if self.name == "rpm":
            return outs[:self.cfg.num_train_reg_iter]
        return outs[:2] if self.name == "dcp" else outs[:1]

    def loss(self, outs, b, u4, lines=None):
        """(the training loss on ``outs``, stage-1 counts, the lines)."""
        G, M, IK, RS, PB, LS = self.mods[:6]
        with self.torch.no_grad(), _Recorder(LS, M, lines) as rec:
            if self.name == "dcp":
                total, _ = LS.dcp_train_loss(b, *outs, self.cfg.loss, u4=u4)
            elif self.name == "fmr":
                total, _ = LS.fmr_train_loss(outs[0], outs[1], b, self.cfg.loss, MAXITER5,
                                             u4=u4)
            else:
                n = self.cfg.num_train_reg_iter
                losses, _ = LS.rpm_cal_loss(outs[:n], outs[n:], b, self.cfg.loss, u4=u4)
                total = LS.rpm_total_loss(losses)
        return float(total), rec.counts, rec.lines[0]


def _step_numbers(torch, ad, m, gen, label):
    """``train_step`` fed from the cache: ms/step, peak memory, a 5-step
    profile (failing on a host-to-device copy) with, for RPM-Net,
    GroupNorm's device time in the step's own trace."""
    import contextlib

    from a_robust_registration_loss_tpu_torch.models.common import TorchGroupNorm

    step_cfg = ad.cfg
    if ad.name == "fmr":
        import dataclasses

        step_cfg = dataclasses.replace(ad.cfg, fit=ad.H.FitConfig())
    st = {"s": ad.state(m), "it": iter(ad.cache)}

    def one():
        b = next(st["it"], None)
        if b is None:
            st["it"] = iter(ad.cache)
            b = next(st["it"])
        st["s"], st["m"] = ad.T.train_step(m, st["s"], b, step_cfg, generator=gen)

    for _ in range(WARMUP2):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAD_ITERS3):
        one()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / GRAD_ITERS3
    torch.cuda.reset_peak_memory_stats()
    one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"{ad.name} {label} train_step fed from the DeviceCache: {ms:.4f} ms/step over "
          f"{GRAD_ITERS3}; peak memory {peak:.1f} MiB; its profile:", flush=True)
    st["it"] = iter(ad.cache)
    label_gn = "bf16.group_norm" if ad.name == "rpm" else None
    with (_Spans(m, TorchGroupNorm, label_gn) if label_gn else contextlib.nullcontext()):
        prof = profile_phase(torch, one, PROFILED3, "step", ms, strict=False, label=label_gn)
    check(prof is not None and prof["htod"] == 0,
          f"{ad.name} {label} steps fed from the cache copied to the device: {prof}")
    check(all(p.dtype == torch.float32 for p in m.parameters()),
          f"{ad.name} {label}: a parameter left fp32")
    # the products: the library's matrix-multiply kernels, and of them the
    # tensor cores' (named bf16 or tensorop, or cuBLAS's Hopper nvjet
    # kernels, which no fp32 product takes with TF32 off); the fp32 ones are
    # SIMT kernels (sm80_xmma_gemm_f32f32, cutlass simt sgemm)
    gemms = {k: v for k, v in prof["ms_by_kernel"].items() if any(
        w in k for w in ("gemm", "nvjet", "xmma", "cutlass"))}
    tensor_core = sum(v for k, v in gemms.items()
                      if any(w in k for w in ("bf16", "tensorop", "nvjet")))
    print(f"{ad.name} {label}: matrix-multiply kernels {sum(gemms.values()):.4f} ms/step, "
          f"{tensor_core:.4f} of it on the tensor cores; the costliest: "
          + "; ".join(f"{v:.4f} ms {k[:70]}" for k, v in sorted(gemms.items(),
                                                               key=lambda kv: -kv[1])[:4]),
          flush=True)
    out = dict(ms_step=ms, peak_mib=peak, kernels=prof["kernels"], busy_ms=prof["busy_ms"],
               busy_share=prof["busy_share"], htod=prof["htod"],
               waits=prof["syncs"] / PROFILED3, gemm_ms=sum(gemms.values()),
               tensor_core_gemm_ms=tensor_core)
    if label_gn:
        out["groupnorm_ms"] = prof["labelled_ms"]
        out["groupnorm_share"] = prof["labelled_ms"] / prof["busy_ms"]
    return out


def bf16_phase(torch, mods, data, tmp, name):
    """One trainer in bf16 at the width of its fp32 phase (module docstring,
    phase 18). Returns ({path: launches}, the numbers of both dtypes)."""
    from a_robust_registration_loss_tpu_torch.utils import debug

    G, M, IK, RS, PB, LS, GK = mods[:7]
    fp32 = FP32_RUNS[name]
    T = {"dcp": "train.dcp", "fmr": "train.fmr", "rpm": "train.rpmnet"}[name]
    run = os.path.join(tmp, f"{name}_bf16")
    args = fp32["args"] + ["--dtype", "bfloat16", "--exp_dir", run]
    torch.cuda.synchronize()
    counts(IK, RS, PB, reset=True)
    t0 = time.perf_counter()
    if name == "rpm":
        from a_robust_registration_loss_tpu_torch.train import rpmnet as TR

        with _StepCounts(TR, IK, RS, PB) as sc:
            model, _, hist = TR.main(args)
        launches = counts(IK, RS, PB)
        check(sc.calls == fp32["calls"], f"RPM-Net bf16 steps by kind: {sc.calls}")
        paths = {"rpm_bf16_pretrain": sc.totals["pretrain"],
                 "rpm_bf16_train": {n: launches[n] - sc.totals["pretrain"][n]
                                    for n in launches}}
    else:
        from a_robust_registration_loss_tpu_torch.train import dcp as TD
        from a_robust_registration_loss_tpu_torch.train import fmr as TF

        model, _, hist = {"dcp": TD, "fmr": TF}[name].main(args)
        launches = counts(IK, RS, PB)
        check_counts(launches, fp32["per_step"], fp32["steps"], f"{name} bf16 train")
        paths = {f"{name}_bf16_train": launches}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    secs = _epoch_seconds(run)
    rel = [abs(h["loss"] - f["loss"]) / abs(f["loss"]) for h, f in zip(hist, fp32["hist"])]
    print(f"{name} bf16 through {T}.main --dtype bfloat16 ({dt:.2f} s, CLI included): train "
          f"loss by epoch {[h['loss'] for h in hist]} against fp32's "
          f"{[h['loss'] for h in fp32['hist']]}, rel {[f'{x:.3g}' for x in rel]}; "
          f"time/epoch_seconds {secs} against fp32's {fp32['secs']}; launches {launches}",
          flush=True)
    check(model.cfg.dtype == "bfloat16" and len(rel) == len(fp32["hist"]) > 0,
          f"{name} bf16: the run's config or epochs")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          f"{name} bf16: the trained parameters are not fp32")
    for h in hist:
        check(all(np.isfinite(v) for v in h.values()) and h["nonfinite_steps"] == 0.0,
              f"{name} bf16: {h}")
    if name != "fmr":
        check(max(rel) <= BF16_TRAIN_REL, f"{name} bf16 train loss against fp32's: {rel}")

    ad = _Adapter(torch, mods, name, model, data)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mbf, m32 = ad.model(weights, "bfloat16"), ad.model(weights, "float32")
    batch = next(iter(ad.cache))
    gen = gen_on(torch, 9)
    u4 = LS.draw_uniforms(B5, ad.n_lines, DEV, gen)

    # the card's bf16 forward against its fp32 forward
    outs_bf, idx = ad.forward(mbf, batch)
    outs_32, _ = ad.forward(m32, batch, idx)
    tf_bar, ende_bar = BF16_FP32[name]
    tf_err = max(float((a - b).abs().max()) for a, b in zip(ad.transforms(outs_bf),
                                                           ad.transforms(outs_32)))
    check(all(o.dtype == torch.float32 for o in outs_bf), f"{name} bf16: an output is not fp32")
    rots = {"dcp": outs_bf[:1], "fmr": [outs_bf[0][-1][..., :3, :3]],
            "rpm": [x[..., :3, :3] for x in ad.transforms(outs_bf)]}[name]
    det_err = max(float((torch.linalg.det(r) - 1).abs().max()) for r in rots)
    line = (f"{name}: the card's bf16 forward against its fp32 forward (the same weights and "
            f"batch): transforms within {tf_err:.4g} (bar {tf_bar}), det R within {det_err:.3g} "
            "of 1 (bar 1e-3)")
    check(tf_err <= tf_bar and det_err <= 1e-3, line)
    if name == "fmr":
        ende = abs(float(outs_bf[1]) - float(outs_32[1])) / abs(float(outs_32[1]))
        same_g = torch.equal(outs_bf[0], outs_32[0])
        line += (f"; loss_ende {float(outs_bf[1]):.6f} against {float(outs_32[1]):.6f} (rel "
                 f"{ende:.3g}, bar {ende_bar}); the solver's iterates equal bit for bit: "
                 f"{same_g}")
        check(ende <= ende_bar and same_g, line)
    print(line, flush=True)

    # the card's bf16 step against the CPU's bf16 step: the same weights,
    # batch, lines and ball indices
    t1 = time.perf_counter()
    total_k, counts_k, lines = ad.loss(outs_bf, batch, u4)
    if name == "rpm":  # the kernels on this bf16 step's own inputs
        rpm_kernels(torch, mods, ad.cfg, batch, [o.detach() for o in ad.transforms(outs_bf)],
                    u4, lines, counts_k)
        table = torch.cat([batch["points_src_sample"], batch["normals_src"]], dim=-1)
        flat = idx[0].to(DEV).reshape(B5, -1)
        check(torch.equal(GK.gather_rows_fwd(table, flat), GK.gather_rows_reference(table, flat)),
              "the gather on the bf16 step's ball query differs from its plain version")
        print(f"RPM-Net's gather on the bf16 step's ball query ({tuple(flat.shape)}) equals its "
              "plain version bit for bit", flush=True)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    cpu_model = ad.model({k: v.cpu() for k, v in weights.items()}, "bfloat16", "cpu")
    outs_c, _ = ad.forward(cpu_model, cpu_batch, [i.cpu() for i in idx])
    same_c, same_counts, _ = ad.loss([o.cpu() for o in outs_bf], cpu_batch, u4.cpu(), lines.cpu())
    own_c, own_counts, _ = ad.loss(outs_c, cpu_batch, u4.cpu(), lines.cpu())
    same_err = abs(total_k - same_c) / abs(same_c)
    own_err = abs(total_k - own_c) / abs(own_c)
    cpu_tf = max(float((a.cpu() - b).abs().max()) for a, b in zip(ad.transforms(outs_bf),
                                                                  ad.transforms(outs_c)))
    moved = sum(int((a != b).sum()) for a, b in zip(counts_k, own_counts))
    n_counts = sum(a.size for a in counts_k)
    check(len(counts_k) == len(same_counts) == len(own_counts), f"{name}: metric calls")
    same_moved = sum(int((a != b).sum()) for a, b in zip(counts_k, same_counts))
    line = (f"{name}: the card's bf16 step against the CPU's bf16 step ({time.perf_counter() - t1:.1f}"
            f" s): on the card's outputs loss {total_k:.7f} vs {same_c:.7f} (rel {same_err:.3g}, "
            f"bar {BF16_CPU['same_loss']}), {same_moved} of {n_counts} stage-1 counts moved (bar "
            f"{BF16_CPU['same_counts']:.0e}); each side's own "
            f"forward: transforms within {cpu_tf:.4g} (bar {BF16_CPU['transforms']}), loss "
            f"{own_c:.7f} (rel {own_err:.3g}, bar {BF16_CPU['loss']}), {moved} of {n_counts} "
            f"stage-1 counts moved (bar {BF16_CPU['counts']:.0%})")
    print(line, flush=True)
    check(same_err <= BF16_CPU["same_loss"] and same_moved <= BF16_CPU["same_counts"] * n_counts
          and cpu_tf <= BF16_CPU["transforms"]
          and own_err <= BF16_CPU["loss"] and moved <= BF16_CPU["counts"] * n_counts, line)

    # the numbers of both dtypes, side by side, from the same weights
    numbers = {}
    for dtype in ("float32", "bfloat16"):
        numbers[dtype] = _step_numbers(torch, ad, ad.model(weights, dtype), gen_on(torch, 10),
                                       dtype)
    numbers["float32"]["s_epoch"], numbers["bfloat16"]["s_epoch"] = fp32["secs"], secs
    print(f"{name} bf16 against fp32 on the card (NVIDIA card above): "
          + "; ".join(f"{k} {numbers['bfloat16'][k]:.4g} vs {numbers['float32'][k]:.4g}"
                      for k in numbers["float32"] if k != "s_epoch")
          + f"; s/epoch {secs} vs {fp32['secs']}", flush=True)

    # a poisoned batch: skipped without --debug_nans, raises with it
    poisoned = dict(batch)
    poisoned["points_src_sample"] = batch["points_src_sample"].clone()
    poisoned["points_src_sample"][0, 0, 0] = float("nan")
    mp = ad.model(weights, "bfloat16")
    st = ad.state(mp)
    step_cfg = ad.cfg
    if name == "fmr":
        import dataclasses

        step_cfg = dataclasses.replace(ad.cfg, fit=ad.H.FitConfig())
    after, m = ad.T.train_step(mp, st, poisoned, step_cfg, generator=gen)
    flat_state = lambda s: list(s.adam) + [s.count] if name == "rpm" else list(s)  # noqa: E731
    check(float(m["nonfinite_steps"]) == 1.0 and all(
        torch.equal(v, weights[k]) for k, v in mp.state_dict().items()) and all(
        torch.equal(a, b) for a, b in zip(flat_state(after), flat_state(st))),
        f"{name} bf16: the NaN batch was not skipped with the state unchanged")
    debug.name_modules(mp)
    raised = None
    with debug.anomaly_detection():
        try:
            ad.T.train_step(mp, st, poisoned, step_cfg, generator=gen)
        except FloatingPointError as e:
            raised = e
    check(raised is not None, f"{name} bf16 --debug_nans: the NaN batch did not raise")
    print(f"{name} bf16: the NaN batch skipped with the state unchanged; under --debug_nans "
          f"it raises FloatingPointError: {raised}", flush=True)
    return paths, dict(numbers, train_loss_rel=rel, transforms_vs_fp32=tf_err,
                       transforms_vs_cpu=cpu_tf, loss_vs_cpu=own_err, counts_moved=moved)



SHARD_SHAPES = ((2, 1), (1, 2))  # the meshes of the sharded steps, 2 ranks on the one card
SHARD_TIMED = 3  # steps each rank times after the 2 it compares
SHARD_TIMEOUT_S = 120.0  # each collective of the sharded phase
SHARD_JOIN_S = 120.0  # the world of 2 ranks, start to finish (17 s on the H100)
SHARD_UPDATE = 0.25  # the update of 2 steps, relative L2 to one process's
SHARD_GRAD2 = 5e-3  # the second step's gradient, relative L2 (its second moment: twice)
SHARD_CLI = (2, 2)  # DCP's CLI: 4 ranks on the one card
SHARD_STEP = {  # a training step's launches on each rank, whatever the mesh
    "dcp": {"resample_batched": 1, "stage1_pair_pts": 1},
    "fmr": {"resample_batched": 1, "stage1_pair_pts": 3},
    "rpm": RPM_STEPS["train"]}


def shard_config(name):
    """(the trainer's step module, its config at its phase's width): DCP at
    the CLI's defaults with its cycle term (computed whole on every sp
    member), FMR at ``FMRConfig``'s, RPM-Net at ``RPMNetConfig``'s. Each at
    lr 1e-6 (RPM-Net's default is 2e-5): Adam turns a near-0 gradient,
    summed in another order under a mesh, into a step of +-lr of either
    sign, 4 lr apart after 2 steps, and the parameters' bar is 1e-5. That
    bar cannot tell a wrong update from a right one at this lr: the phase
    also holds the update itself, relative to one process's, and each
    step's gradient and second moment."""
    from a_robust_registration_loss_tpu_torch.models.dcp import DCPConfig
    from a_robust_registration_loss_tpu_torch.models.fmr import FMRConfig
    from a_robust_registration_loss_tpu_torch.models.rpmnet import RPMNetConfig
    from a_robust_registration_loss_tpu_torch.train import dcp as TD
    from a_robust_registration_loss_tpu_torch.train import fmr as TF
    from a_robust_registration_loss_tpu_torch.train import losses as LS
    from a_robust_registration_loss_tpu_torch.train import rpmnet as TR

    if name == "dcp":
        return TD, TD.DCPTrainConfig(loss=LS.LossConfig(n_lines=L5, cycle=True),
                                     model=DCPConfig(emb_nn="pointnet", cycle=True))
    if name == "fmr":
        return TF, TF.FMRTrainConfig(loss=LS.LossConfig(n_lines=L5),
                                     model=FMRConfig(num_points=NP5))
    return TR, TR.RPMTrainConfig(max_lr=1e-6, loss=LS.LossConfig(n_lines=L_RPM),
                                 model=RPMNetConfig())


def shard_steps(torch, name, batch, handed=None, mesh=None, timed=0):
    """2 training steps of ``name`` (``shard_config``) from the seed-0
    weights on ``batch`` (numpy, the global batch; this rank's rows under
    the mesh its size allows), then ``timed`` more, on the card.

    ``handed``: one process's (lines of each compared step, whole;
    ``batch_lines``' inputs of its first step; RPM-Net's ball indices of
    each call in the compared steps, whole). The steps take those lines and
    indices in place of the ones they make, which they record: the
    gradient, summed in another order under a mesh, may move an ulp of a
    parameter, a library product rounds a sample otherwise in a batch of
    another size (cuBLAS picks its kernels by shape), and an ulp of the
    predicted source's box moves the resampler's knife-edge labels, where
    one flipped candidate shifts every later line
    (``tests/torch_parallel_ranks.py:steps``); the ball query's d^2 <= r^2
    test has a knife edge of its own (phase 17). Under a mesh ``batch_lines``
    also runs once on one process's first-step inputs (this rank's rows of
    them): ``replayed``. Returns each compared step's loss, Adam's first
    moment after each (0.1 g_1, then 0.09 g_1 + 0.1 g_2) and second moment
    after the second, and the lines drawn; the first step's
    ``batch_lines`` inputs and stage-1 counts; the ball indices and how
    many of their rows the handed ones moved; the lines each stage-1 launch
    swept and each resampler launch's batch; the launches of the 2 steps;
    the parameters before and after them; ms a timed step and the collectives' ms a
    timed step."""
    from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
    from a_robust_registration_loss_tpu_torch.ops.cuda import probe as PB
    from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
    from a_robust_registration_loss_tpu_torch.parallel import mesh as PM
    from a_robust_registration_loss_tpu_torch.train import harness as H
    from a_robust_registration_loss_tpu_torch.train import losses as LS

    mod, cfg = shard_config(name)
    model = mod.init_model(cfg, 0, DEV)
    opt = (H.scheduled_adam_init if name == "rpm" else H.adam_init)(model.parameters())
    data = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    if mesh is not None:
        mesh = mesh.for_rows(data["points_src_sample"].shape[0])
        data = PM.shard_batch(data, mesh)
    cfg = H.with_mesh(cfg, mesh)
    gen = gen_on(torch, 5)
    swept, rows, coll = [], [], [0.0]
    from a_robust_registration_loss_tpu_torch.ops import metric as M

    reals = (LS.batch_lines, IK.stage1, RS.sample_and_hit, PM.Mesh.all_reduce,
             PM.Mesh.all_gather, M.rigid_slots)
    slot_counts = []

    def rigid_slots(*args, **kw):
        got = reals[5](*args, **kw)
        if not drawn or len(drawn) == 1:  # the first step's stage-1 counts
            slot_counts.append(torch.stack(got[2:]).cpu())
        return got

    drawn, inputs, balls, moved = [], [], [], []
    shard = lambda x: x if mesh is None else PM.dp_rows(x, mesh)  # noqa: E731
    from a_robust_registration_loss_tpu_torch.models import rpmnet as RM

    real_ball = RM.query_ball_point_excl

    def ball(*args, **kw):
        balls.append(real_ball(*args, **kw))
        if handed is None or len(balls) > len(handed[2]):
            return balls[-1]
        given = shard(handed[2][len(balls) - 1].to(DEV))
        moved.append(int((given != balls[-1]).any(-1).sum()))
        return given

    def lines(*args, **kw):
        if not inputs:
            inputs.append(([a.detach().cpu() if torch.is_tensor(a) else a for a in args],
                           {k: v for k, v in kw.items() if k != "mesh"}))
        drawn.append(reals[0](*args, **kw))
        if handed is None or len(drawn) > len(handed[0]):  # the timed steps draw their own
            return drawn[-1]
        got = handed[0][len(drawn) - 1].to(DEV)
        return got if mesh is None else PM.line_shard(shard(got), mesh)

    def stage1(neis, lines_, *args, **kw):
        swept.append(lines_.shape[-2])
        return reals[1](neis, lines_, *args, **kw)

    def sample_and_hit(u4, *args, **kw):
        rows.append(u4.shape[0] if u4.dim() == 3 else 1)
        return reals[2](u4, *args, **kw)

    def collective(real):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real(self, *args, **kw)
            finally:
                torch.cuda.synchronize()
                coll[0] += time.perf_counter() - t0
        return run

    LS.batch_lines, IK.stage1, RS.sample_and_hit = lines, stage1, sample_and_hit
    RM.query_ball_point_excl, M.rigid_slots = ball, rigid_slots
    PM.Mesh.all_reduce, PM.Mesh.all_gather = collective(reals[3]), collective(reals[4])
    out = dict(loss=[], lines=[])
    if mesh is not None:  # one process's first-step inputs: this rank's rows of them
        (u4, *rest), kw = handed[1]
        rest = [shard(a.to(DEV)) if torch.is_tensor(a) else a for a in rest]
        out["replayed"] = reals[0](u4.to(DEV), *rest, mesh=mesh, **kw).cpu()
    out["init"] = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
    try:
        torch.cuda.synchronize()
        counts(IK, RS, PB, reset=True)
        for i in range(2):
            opt, m = mod.train_step(model, opt, data, cfg, generator=gen)
            out["loss"].append(float(m["loss"]))
            out["lines"].append(drawn[-1].cpu())
            state = opt.adam if name == "rpm" else opt
            out["mu" if i == 0 else "mu2"] = state.mu.cpu()
        out["nu2"] = state.nu.cpu()
        torch.cuda.synchronize()
        out["launches"] = counts(IK, RS, PB)
        out["inputs"], out["balls"], out["moved"] = inputs[0], [b.cpu() for b in balls], moved
        out["counts"] = slot_counts
        out["params"] = {k: v.cpu() for k, v in model.state_dict().items()}
        out["swept"], out["rows"] = list(swept), list(rows)
        step_s, coll[0] = [], 0.0
        for _ in range(timed):
            t0 = time.perf_counter()
            opt, m = mod.train_step(model, opt, data, cfg, generator=gen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        out["ms_step"] = [1e3 * x for x in step_s]
        out["coll_ms_step"] = 1e3 * coll[0] / max(timed, 1)
    finally:
        LS.batch_lines, IK.stage1, RS.sample_and_hit = reals[:3]
        PM.Mesh.all_reduce, PM.Mesh.all_gather = reals[3:5]
        RM.query_ball_point_excl, M.rigid_slots = real_ball, reals[5]
    return out


def rpm_f64_gradient(torch, batch, lines):
    """The float64 yardstick of RPM-Net's first sharded step (its SVD
    amplifies rounding, phase 17): on the card the loss of one process's
    forward from the seed-0 weights on one process's lines, and its
    gradient at the network's outputs; from that gradient the network's
    backward to every parameter on the CPU, with the card's ball indices
    (``rpm_parity``'s method), in float64 and in fp32; and on the card from
    the same gradient, the whole batch's backward and the sum of its two
    halves' (B = 2 each, as under dp). Returns the four flat gradients."""
    from a_robust_registration_loss_tpu_torch.models import rpmnet as RM
    from a_robust_registration_loss_tpu_torch.ops import metric as M
    from a_robust_registration_loss_tpu_torch.train import losses as LS

    mod, cfg = shard_config("rpm")
    n_iter = cfg.num_train_reg_iter
    model = mod.init_model(cfg, 0, DEV)
    b = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    with _Handed(RM) as hand:
        transforms, ep = mod.forward(model, b, n_iter)
    outs = list(transforms) + list(ep["perm_matrices"])
    leaves = [o.detach().requires_grad_(True) for o in outs]
    with _Recorder(LS, M, lines.to(DEV)):
        losses, _ = LS.rpm_cal_loss(leaves[:n_iter], leaves[n_iter:], b, cfg.loss,
                                    generator=gen_on(torch, 0))
    up = torch.autograd.grad(LS.rpm_total_loss(losses), leaves)
    flat = lambda g: torch.cat([x.reshape(-1) for x in g]).double().cpu()  # noqa: E731
    card = flat(torch.autograd.grad(outs, list(model.parameters()), up))
    halves = 0
    for h in (slice(0, B5 // 2), slice(B5 // 2, B5)):
        with _Handed(RM, [i[h] for i in hand.seen]):
            th, eph = mod.forward(model, {k: v[h] for k, v in b.items()}, n_iter)
        halves = halves + flat(torch.autograd.grad(list(th) + list(eph["perm_matrices"]),
                                                   list(model.parameters()),
                                                   [u[h] for u in up]))
    out = []
    for dtype in (torch.float64, torch.float32):
        m = RM.RPMNetEarlyFusion(cfg.model).to(dtype)
        m.load_state_dict({k: v.cpu().to(dtype) for k, v in model.state_dict().items()})
        bc = {k: (v.cpu().to(dtype) if v.is_floating_point() else v.cpu()) for k, v in b.items()}
        real_gather = RM.GK.gather_rows
        RM.GK.gather_rows = RM.GK.gather_rows_reference  # the plain version takes float64
        try:
            with _Handed(RM, [i.cpu() for i in hand.seen]):
                tc, epc = mod.forward(m, bc, n_iter)
        finally:
            RM.GK.gather_rows = real_gather
        g = torch.autograd.grad(list(tc) + list(epc["perm_matrices"]), list(m.parameters()),
                                [u.cpu().to(dtype) for u in up])
        out.append(flat(g))
    return out + [card, halves]


def shard_rank(mesh12, inputs):
    """A rank of the sharded phase's world of 2 ranks on the one card (over
    gloo): each trainer's steps under (2, 1) and (1, 2) on the parent's
    inputs."""
    import torch

    from a_robust_registration_loss_tpu_torch.parallel import mesh as PM

    out = {}
    for shape in SHARD_SHAPES:
        mesh = mesh12 if shape == (mesh12.dp, mesh12.sp) else PM.make_mesh(*shape)
        for name, (batch, handed) in inputs.items():
            out[name, shape] = shard_steps(torch, name, batch, handed, mesh, SHARD_TIMED)
    return out


def sharded_phase(torch, mods, data, tmp):
    """Data and line parallelism on the one card (module docstring, phase
    20), its ranks over gloo, which stages every collective through the
    host: nothing here is a scaling figure. Returns the ranks' launches of
    the compared steps, summed."""
    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.parallel import mesh as PM
    from a_robust_registration_loss_tpu_torch.train import dcp as TD

    inputs, single = {}, {}
    for name in SHARD_STEP:
        train, _ = DS.generate_datasets(DS.DatasetConfig(
            data_path=data, layout="views", train_count=TRAIN5, train_batch=B5,
            dcp=name == "dcp", fmr=name == "fmr"), device=DEV)
        batch = next(iter(train))
        single[name] = shard_steps(torch, name, batch, timed=SHARD_TIMED)
        inputs[name] = (batch, (single[name]["lines"], single[name]["inputs"],
                                single[name]["balls"]))
    t0 = time.perf_counter()
    ranks = PM.launch(shard_rank, *SHARD_SHAPES[1], args=(inputs,), device=DEV,
                      timeout_s=SHARD_TIMEOUT_S, join_s=SHARD_JOIN_S, workdir=tmp, results=True)
    world_s = time.perf_counter() - t0
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    g64, g_cpu, g_card, g_halves = rpm_f64_gradient(torch, inputs["rpm"][0],
                                                    single["rpm"]["lines"][0])
    print(f"RPM-Net's network backward from one upstream gradient, from float64: the card "
          f"at B = {B5} {rel(g_card, g64):.3g}, its two halves summed {rel(g_halves, g64):.3g} "
          f"(to each other {rel(g_halves, g_card):.3g}), the CPU's fp32 {rel(g_cpu, g64):.3g}",
          flush=True)
    g_of = lambda g: g["mu"].double() / 0.1  # noqa: E731  (Adam's first moment from 0)
    g2_of = lambda g: (g["mu2"].double() - 0.9 * g["mu"].double()) / 0.1  # noqa: E731
    flat = lambda d: torch.cat([v.reshape(-1).double() for _, v in sorted(d.items())  # noqa: E731
                                if v.is_floating_point()])
    total = {}
    for name, want in single.items():
        L = want["lines"][0].shape[1]
        print(f"sharded {name} one process on the card: {np.mean(want['ms_step']):.2f} ms a "
              f"step ({', '.join(f'{x:.2f}' for x in want['ms_step'])})", flush=True)
        for shape in SHARD_SHAPES:
            dp, sp = shape
            got = [r[name, shape] for r in ranks]
            what = f"sharded {name} {shape}"
            for r, g in enumerate(got):
                i, j = divmod(r, sp)
                n = B5 // dp
                mine = want["lines"][0][i * n:(i + 1) * n, j * L // sp:(j + 1) * L // sp]
                same = torch.equal(g["lines"][0], mine)
                equal_rows = int((g["lines"][0] == mine).all(-1).sum())
                pred = float((g["inputs"][0][4] - want["inputs"][0][4][i * n:(i + 1) * n])
                             .abs().max())
                balls = (f"; its ball queries' rows that differ from one process's, by call: "
                         f"{g['moved']}" if name == "rpm" else "")
                moved = [int((c != w[:, i * n:(i + 1) * n, j * L // sp:(j + 1) * L // sp])
                             .sum()) for c, w in zip(g["counts"], want["counts"])]
                balls += (f"; on one process's lines, its first step's stage-1 counts that "
                          f"differ from one process's, by call: {moved} of "
                          f"{g['counts'][0].numel()}")
                check(sum(moved) == 0 or dp > 1, f"{what} rank {r}: stage-1 counts differ "
                      "from one process's on the same batch and lines")
                print(f"{what} rank {r}: batch_lines on one process's inputs gives its rows "
                      f"and line shard bit for bit: {torch.equal(g['replayed'], mine)}; on its "
                      f"own forward's: {same} ({equal_rows} of {mine.shape[0] * mine.shape[1]} "
                      f"lines equal; the predicted source within {pred:.3g} of one process's)"
                      f"{balls}; stage 1 swept {sorted(set(g['swept']))} lines a launch, the "
                      f"resampler {sorted(set(g['rows']))} samples", flush=True)
                check(torch.equal(g["replayed"], mine),
                      f"{what} rank {r}: batch_lines on one process's inputs differs")
                check(same or dp > 1, f"{what} rank {r}: its lines differ from one process's "
                      "on the same batch")
                check(set(g["swept"]) == {L // sp} and set(g["rows"]) == {B5},
                      f"{what} rank {r}: stage 1 swept {g['swept']}, the resampler took "
                      f"{g['rows']}")
                check_counts(g["launches"], SHARD_STEP[name], 2, f"{what} rank {r}")
                for k, v in g["launches"].items():
                    total[k] = total.get(k, 0) + v
            loss0 = np.mean([g["loss"][0] for g in got])
            loss1 = np.mean([g["loss"][1] for g in got])
            e0 = abs(loss0 - want["loss"][0]) / abs(want["loss"][0])
            e1 = abs(loss1 - want["loss"][1]) / abs(want["loss"][1])
            eg = max(rel(g["mu"], want["mu"]) for g in got)
            f64 = ""
            if name == "rpm":  # its SVD amplifies rounding: the float64 yardstick
                e64 = max(rel(g_of(g), g64) for g in got)
                one64, cpu64 = rel(g_of(want), g64), rel(g_cpu, g64)
                f64 = (f" (from float64 {e64:.3g}, one process on the card {one64:.3g}, the "
                       f"CPU's fp32 {cpu64:.3g})")
            ep = max(float((g["params"][k] - v).abs().max()) for g in got
                     for k, v in want["params"].items())
            # the second step: its gradient and Adam's second moment; the
            # update of both steps, which Adam makes about lr sign(g) a step
            eg2 = max(rel(g2_of(g), g2_of(want)) for g in got)
            en2 = max(rel(g["nu2"].double(), want["nu2"].double()) for g in got)
            init = flat(want["init"])
            eu = max(rel(flat(g["params"]) - init, flat(want["params"]) - init) for g in got)
            replicas = all(torch.equal(got[0]["params"][k], got[1]["params"][k])
                           for k in want["params"])
            line = (f"{what}: loss of the first step rel {e0:.3g} (equal: "
                    f"{[g['loss'][0] for g in got] == [want['loss'][0]] * 2}), of the second "
                    f"{e1:.3g}; gradient rel L2 {eg:.3g}{f64}, the second step's {eg2:.3g}, "
                    f"Adam's second moment after it {en2:.3g}; parameters after 2 steps within "
                    f"{ep:.3g}, the two ranks' equal: {replicas}; their update rel L2 {eu:.3g}; "
                    f"per rank, 2 ranks sharing one "
                    f"card through the host (gloo), not a scaling figure: ms a step "
                    + "; ".join(f"rank {r} {np.mean(g['ms_step']):.2f} "
                                f"({', '.join(f'{x:.2f}' for x in g['ms_step'])}), "
                                f"collectives {g['coll_ms_step']:.2f}"
                                for r, g in enumerate(got)))
            print(line, flush=True)
            # under sp every rank runs one process's forward on one process's
            # batch: the first loss is one process's; under dp the network
            # runs at B = 2, which cuBLAS rounds otherwise than B = 4, so
            # the first loss takes the bar between two paths that round
            # differently (the card against the CPU); the second step starts
            # from parameters that Adam's sign noise moved by up to 2 lr,
            # which moves knife-edge hits: the bar of each side's own
            # forward in phase 17
            # which moves knife-edge hits: the bar of each side's own
            # forward in phase 17. The second step's gradient starts from
            # parameters 2 lr apart on the same lines, and under dp its
            # network rounds at B = 2 again: FMR's, whose Jacobian amplifies
            # rounding about 100 times, read 9.3e-4 where its first read
            # 3.8e-4; a gradient that misses or doubles a rank's share reads
            # 0.3 or more. The update's bar: a near-0 gradient's noisy sign
            # flips its parameter's step, where a skipped, doubled or
            # reversed update reads 1 or more
            grad_ok = eg <= 5e-4 or (name == "rpm" and e64 <= 2 * max(one64, cpu64))
            check(e0 <= 1e-4 and e1 <= 2e-3 and grad_ok and eg2 <= SHARD_GRAD2
                  and en2 <= 2 * SHARD_GRAD2 and ep <= 1e-5 and eu <= SHARD_UPDATE
                  and replicas, line)
            if sp > 1:
                check(all(g["loss"][0] == want["loss"][0] for g in got),
                      f"{what}: the first step's loss is not one process's")

    # DCP's CLI on 4 ranks of the card at lr 0, against one process
    args = ["--data_path", data, "--layout", "views", "--train_count", str(TRAIN5),
            "--batch_size", str(B5), "--n_lines", str(L5), "--seed", "0", "--device", DEV,
            "--epochs", "1", "--lr", "0"] + DCP_CLI
    one, run = os.path.join(tmp, "shard_one"), os.path.join(tmp, "shard_cli")
    hist = TD.main(args + ["--exp_dir", one])[2]
    t0 = time.perf_counter()
    dp, sp = SHARD_CLI
    check(TD.main(args + ["--exp_dir", run, "--dp", str(dp), "--sp", str(sp)]) is None,
          "the spawning CLI returned a result")
    cli_s = time.perf_counter() - t0
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    got = {r["tag"]: r["value"] for r in recs}
    keys = [(r["tag"], r["step"]) for r in recs]
    check(len(keys) == len(set(keys)), "the sharded CLI's metrics.jsonl repeats a record")
    check("ckpt-0" in os.listdir(os.path.join(run, "checkpoints")),
          "the sharded CLI wrote no checkpoint")
    errs = {f"{tag}/{k}": abs(got[f"{tag}/{k}"] - hist[0][f"{pre}{k}"]) / abs(hist[0][f"{pre}{k}"])
            for tag, pre in (("train", ""), ("test", "test_"))
            for k in ("loss", "loss_intersection")}
    line = (f"sharded DCP CLI --dp {dp} --sp {sp} ({dp * sp} ranks sharing one card through "
            f"the host, gloo), 1 epoch at lr 0: {cli_s:.1f} s (spawn, data and set-up "
            f"included), time/epoch_seconds {got['time/epoch_seconds']:.2f} against one "
            f"process's {_epoch_seconds(one)}; losses against one process's: "
            + ", ".join(f"{k} rel {v:.3g}" for k, v in errs.items())
            + " (the test batches of 1 go whole to every dp rank: the same forward; a "
            "training batch of 4 runs the network at B = 2 on each, whose rounding moves "
            "knife-edge lines)")
    print(line, flush=True)
    # the train losses: 8.58e-4 apart in both earlier readings of this
    # deterministic run (lr 0, the same seeds); a dp reduction that drops
    # or double-counts a rank reads 0.1 or more
    check(max(v for k, v in errs.items() if k.startswith("test/")) <= 1e-5
          and max(v for k, v in errs.items() if k.startswith("train/")) <= 3e-3, line)
    print(f"sharded: the world of 2 ranks {world_s:.1f} s, spawn included", flush=True)
    return total


def groupnorm_ms(torch, model, step):
    """The device time a step spends in ``model``'s GroupNorm passes: the
    input shape of each GroupNorm call in one ``step()``, then each shape's
    forward and backward timed alone with CUDA events (10 calls after a
    warm-up), added up over the calls. Returns (ms a step, calls a
    step)."""
    from a_robust_registration_loss_tpu_torch.models.common import TorchGroupNorm

    shapes = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: shapes.append((mod, a[0].shape)))
             for m in model.modules() if isinstance(m, TorchGroupNorm)]
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    total = 0.0
    for mod, shape in set(shapes):
        x = torch.randn(shape, device=DEV, requires_grad=True)
        g = torch.randn(shape, device=DEV)
        ms = cuda_ms(torch, lambda: torch.autograd.grad(mod(x), [x, *mod.parameters()], g), 10)
        total += ms * sum(1 for m_, s_ in shapes if m_ is mod and s_ == shape)
    return total, len(shapes)


def gen_on(torch, seed):
    """A generator on the card seeded with ``seed``."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return gen


def _epoch_seconds(exp_dir):
    """The ``time/epoch_seconds`` records of a run's metrics log."""
    with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["value"] for r in recs if r["tag"] == "time/epoch_seconds"]


def main():
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from a_robust_registration_loss_tpu_torch import demo
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
    seconds = {"build": round(time.perf_counter() - t0, 2)}  # wall seconds by phase
    print(f"kernels built in {seconds['build']} s", flush=True)
    print(_build.build_log.strip(), flush=True)

    mods3 = (G, M, IK, RS, PB, LS, GK, D, TD)
    tmp_dir = tempfile.TemporaryDirectory()  # the data phase's files, for phases 14 to 17
    tmp = tmp_dir.name
    data5 = timed(seconds, "data", data_phase, torch, mods3, tmp)
    rpm_gather, rpm_gather_inputs = timed(seconds, "rpm_grouping", rpm_grouping_phase, torch,
                                          mods3, data5)
    probe, rate, probe_launches = timed(seconds, "probe", probe_phase, torch, PB)

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
    pts = timed(seconds, "stage1", stage1_phase, torch, M, IK, data, lines, rate)
    resample = timed(seconds, "resample", resample_phase, torch, G, RS, data, gen, rate)
    src2, n1, n2, lines2 = batch_data(torch, G, LS)
    modes = timed(seconds, "stage1_modes", stage1_modes_phase, torch, M, IK, n1, n2, lines2, rate)
    timed(seconds, "stage1_segments", stage1_segments_phase, torch, M, IK, n1, n2, lines2)
    gather = timed(seconds, "gather", gather_phase, torch, GK, rate)
    t0 = time.perf_counter()
    batches3 = dcp_batches(torch, G)
    torch.cuda.synchronize()
    print(f"DCP data: {BATCHES3} batches of B={B3} N={N3} F={F3}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    resample_batched = timed(seconds, "resample_batched", resample_batch_phase, torch, G, RS,
                             batches3[0], rate)
    cfg3, model3 = dcp_model(torch, D, TD, LS)
    dcp = timed(seconds, "dcp_kernels", dcp_kernels_phase, torch, mods3, cfg3, model3, batches3[0],
                rate)
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

    classical_launches, single_its = timed(seconds, "classical", main_path, torch, classical,
                                           se3, G, M, IK, RS, PB, LN, data, cfg)
    objective, mix = timed(seconds, "batched_metric", batch_path, torch, M, IK, RS, PB, LS,
                           se3, src2, n1, n2, lines2)
    dcp_eval, dcp_grad = timed(seconds, "dcp", dcp_path, torch, mods3, cfg3, model3, batches3)
    classical_batch = timed(seconds, "classical_batch", classical_batch_phase, torch, classical, IK,
                            RS, PB, LN, single_its)
    classical_graph, graph_numbers = timed(seconds, "classical_graph", classical_graph_phase,
                                           torch, classical, IK, RS, PB, LN, False)
    batch_graph, batch_graph_numbers = timed(seconds, "classical_batch_graph",
                                             classical_graph_phase, torch, classical, IK, RS,
                                             PB, LN, True)
    demo_launches = timed(seconds, "demo", demo_phase, torch, demo, IK, RS, PB)
    dcp_train = timed(seconds, "dcp_train", dcp_train_phase, torch, mods3, cfg3, batches3)
    with tmp_dir:
        fmr_train, fmr_eval = timed(seconds, "fmr", fmr_phase, torch, mods3, data5, tmp)
        dcp_cli, dcp_cli_eval = timed(seconds, "dcp_cli", dcp_cli_phase, torch, mods3, data5,
                                      tmp)
        scanned = {name: timed(seconds, f"{name}_scanned", scanned_phase, torch, mods3, data5,
                               tmp, name) for name in ("dcp", "fmr", "rpm")}
        rpm_paths, _ = timed(seconds, "rpm", rpm_phase, torch, mods3, data5, tmp, rate)
        bf16 = {name: timed(seconds, f"{name}_bf16", bf16_phase, torch, mods3, data5, tmp, name)
                for name in ("dcp", "fmr", "rpm")}
        sharded = timed(seconds, "sharded", sharded_phase, torch, mods3, data5, tmp)
    late_gather = timed(seconds, "late_gather", late_gather_phase, torch, GK, rpm_gather,
                        rpm_gather_inputs)
    bf16_paths = {p: c for paths_, _ in bf16.values() for p, c in paths_.items()}
    print("bf16 against fp32 on the card, the same weights and batches (NVIDIA card above): "
          + json.dumps({name: numbers for name, (_, numbers) in bf16.items()}), flush=True)
    paths = {"probe": {"probe_fp32_rate": probe_launches}, "classical": classical_launches,
             "bench_loss_objective": objective, "batched_metric": mix,
             "dcp_evaluate": dcp_eval, "dcp_forward_gradient": dcp_grad,
             "dcp_graph_gather": dcp["graph_gather"], "classical_batch": classical_batch,
             "demo": demo_launches, "dcp_train": dcp_train, "fmr_train": fmr_train,
             "fmr_eval_only": fmr_eval, "dcp_cli_train": dcp_cli,
             "dcp_cli_eval_only": dcp_cli_eval, **rpm_paths, **bf16_paths,
             "sharded_train_steps": sharded, "classical_graph": classical_graph,
             "classical_batch_graph": batch_graph,
             **{f"{name}_scanned": c for name, (c, _) in scanned.items()}}
    print("CUDA graphs against eager on the card (NVIDIA card above): " + json.dumps(
        {"classical": graph_numbers, "classical_batch": batch_graph_numbers,
         **{name: numbers for name, (_, numbers) in scanned.items()}}), flush=True)
    for k in kernels:  # the gather on RPM-Net's own ball query, its first model caller
        if k["name"] in ("gather_fwd", "gather_bwd"):
            t = rpm_gather[k["name"][7:]]
            k["by_shape"]["rpm_model"] = dict(
                shape=t["shape"], max_abs_err=t["err"], ms=t["ms"], call_ms=t["call_ms"],
                plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                bound_ms=bounds(0, t["nbytes"], rate)[1][0], bound_by="bytes",
                **{key: t[key] for key in ("kernels_per_call", "ms_by_kernel") if key in t},
                ms_after_last_phase=late_gather[k["name"][7:]]["ms"])
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items() if c.get(k["name"])}
        k["launches"] = sum(k["launches_by_path"].values())
        check(k["launches"] > 0, f"{k['name']}: launched on no path")
    print(f"wall seconds by phase: {json.dumps(seconds)}", flush=True)
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
