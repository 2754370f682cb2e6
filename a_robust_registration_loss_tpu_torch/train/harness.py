"""The trainers' shared runtime: a guarded Adam step and the epoch loop.

Port of ``a_robust_registration_loss_tpu/train/harness.py`` (its streaming
path; the scanned-epoch path over a device-resident dataset is not ported
yet). ``Trainer.fit`` iterates a loader, runs a train step per batch, logs
epoch aggregates through ``utils.MetricsWriter``, evaluates, checkpoints
through ``utils.CheckPointManager`` and dumps OBJ artifacts, resuming from
the latest checkpoint.

The steps are plain functions on a ``torch.nn.Module`` that they update in
place: ``train_step(model, opt_state, batch, generator) -> (opt_state,
metrics)`` and ``eval_step(model, batch, generator) -> metrics``, metrics a
dict of 0-d device tensors. Randomness comes from one ``torch.Generator`` an
epoch, seeded from ``(FitConfig.seed, epoch)`` (eval's from ``(seed, epoch,
1_000_000)``), the role of the JAX package's ``fold_in(root_key, epoch)``: a
run killed after a checkpoint and resumed reproduces the losses of an
uninterrupted one.

With a (dp, sp) ``mesh`` (``parallel/mesh.py``) every rank runs ``fit``:
each batch is cut to this rank's dp rows and the steps get the mesh it
runs under (``Mesh.for_rows``: a batch whose size does not divide by dp
goes whole to every rank); ``guarded_update`` averages the gradients and
the loss over the dp group before Adam, so a non-finite value on one rank
skips the step on all; the epoch metrics are averaged over the dp group;
rank 0 alone writes the metrics log, the checkpoints and the artifacts,
and every rank restores.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.data import objio
from a_robust_registration_loss_tpu_torch.ops import adam
from a_robust_registration_loss_tpu_torch.ops.adam import AdamState, ScheduledAdamState
from a_robust_registration_loss_tpu_torch.parallel import mesh as PM
from a_robust_registration_loss_tpu_torch.utils import CheckPointManager, MetricsWriter
from a_robust_registration_loss_tpu_torch.utils import debug
from a_robust_registration_loss_tpu_torch.utils.checkpoint import to_host

# metrics keys aggregated by SUM over an epoch instead of the mean (event
# counters; everything else is a per-batch average)
COUNTER_KEYS = frozenset({"nonfinite_steps"})


def adam_init(params) -> AdamState:
    """A fresh Adam state over the parameter tensors ``params``: both
    moments flat, the parameters' total size, concatenated in the list's
    order."""
    params = list(params)
    n = sum(p.numel() for p in params)
    return adam.init(torch.zeros(n, device=params[0].device))


def guarded_update(lr: float, grads, opt_state: AdamState, params, loss, mesh=None):
    """One optax.adam(lr) step on the parameter tensors ``params``, in place,
    SKIPPED when the loss or any gradient is non-finite: then the
    parameters, both moments and the count stay bitwise as they were.

    The metric's welsch(0, 0) quirk (a batch whose distance median is
    exactly 0 gives 0/0 = NaN) would otherwise flow NaN into the moments and
    poison every later step. The skip is the returned 0-d float flag (1.0
    skipped, 0.0 applied), counted per epoch as ``nonfinite_steps``.

    No host sync: the finiteness test (``isfinite`` of every element, which
    no large finite gradient can trip) is the 0-d ``keep`` of
    ``ops/adam.py:step``. The arithmetic runs on the flat concatenation of
    all parameters, so the step costs a few tens of launches whatever their
    number. ``grads`` may hold None for an unused parameter (a zero
    gradient). With ``--debug_nans`` (``utils/debug.py``) a NaN loss raises
    ``FloatingPointError`` instead of being skipped.

    Under a ``mesh`` with dp > 1 the gradient and the loss are first
    averaged over the dp group, in one collective: each rank's loss is its
    rows' estimate of the global one, and a NaN or inf on any rank reaches
    every rank's finiteness test."""
    debug.check_nans("the loss", loss)
    params = list(params)
    with torch.no_grad():
        g = torch.cat([(torch.zeros_like(p) if x is None else x).reshape(-1)
                       for x, p in zip(grads, params)])
        if mesh is not None and mesh.dp > 1:
            g = mesh.dp_mean(torch.cat([g, loss.reshape(1).to(g.dtype)]))
            g, loss = g[:-1], g[-1]
        p = torch.cat([x.reshape(-1) for x in params])
        finite = torch.isfinite(loss) & torch.isfinite(g).all()
        new_p, state = adam.step(lr, g, opt_state, p, finite)
        torch._foreach_copy_(params, [x.view_as(y) for x, y in
                                      zip(new_p.split([y.numel() for y in params]), params)])
        return state, (~finite).float()


def scheduled_adam_init(params) -> ScheduledAdamState:
    """``adam_init`` with the schedule's count beside Adam's, both 0."""
    adam_state = adam_init(params)
    return ScheduledAdamState(adam_state, torch.zeros_like(adam_state.count))


def scheduled_update(schedule, grads, opt_state: ScheduledAdamState, params, loss,
                     mesh=None):
    """``guarded_update`` at the learning rate ``schedule(opt_state.count)``
    (a float or a 0-d tensor on the device, optax.adam(schedule)'s): the
    schedule's count advances with Adam's and, like it, stays where the
    step is skipped. Returns (ScheduledAdamState, nonfinite flag)."""
    adam_state, nonfinite = guarded_update(schedule(opt_state.count), grads, opt_state.adam,
                                           params, loss, mesh)
    count = torch.where(nonfinite == 0, opt_state.count + 1, opt_state.count)
    return ScheduledAdamState(adam_state, count), nonfinite


@dataclasses.dataclass(frozen=True)
class FitConfig:
    epochs: int = 10
    exp_dir: str = "./exps/run"
    save_every: int = 1            # checkpoint cadence (epochs)
    artifacts_every: int = 0       # obj dump cadence (0 = off)
    max_to_keep: int = 5
    keep_every_n_hours: float = 6.0
    seed: int = 1234
    resume: bool = True            # reload the latest checkpoint
    log_tensorboard: bool = True
    async_checkpoints: bool = True  # checkpoint file writes on a thread


def _epoch_seed(*parts: int) -> int:
    """A 64-bit generator seed from a tuple such as (seed, epoch)."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1, np.uint64)[0])


def dump_registration_objs(directory: str, tag, src, pred, tar, gt_src=None):
    """Periodic artifact dumps of one sample: ``{tag}_src.obj``,
    ``_pred_src.obj``, ``_tar.obj`` and, if given, ``_gt_src.obj``."""
    os.makedirs(directory, exist_ok=True)
    objio.write_obj(os.path.join(directory, f"{tag}_src.obj"), np.asarray(src))
    objio.write_obj(os.path.join(directory, f"{tag}_pred_src.obj"),
                    np.asarray(pred))
    objio.write_obj(os.path.join(directory, f"{tag}_tar.obj"), np.asarray(tar))
    if gt_src is not None:
        objio.write_obj(os.path.join(directory, f"{tag}_gt_src.obj"),
                        np.asarray(gt_src))


class _EpochMetrics:
    """Sums one epoch's per-batch metrics on the host, one batch behind:
    each batch's metrics go to the host as one stacked tensor, copied
    without a wait, and are read only after the next batch's step has been
    queued, so the device never idles on the fetch."""

    def __init__(self):
        self.sums, self.n, self._pending = {}, 0, None

    def _absorb(self):
        keys, host, done = self._pending
        if done is not None:
            done.synchronize()
        for k, v in zip(keys, host.tolist()):
            self.sums[k] = self.sums.get(k, 0.0) + v
        self._pending = None

    def push(self, metrics):
        keys = sorted(metrics)
        stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        host = stacked.to("cpu", non_blocking=True)
        done = None
        if stacked.is_cuda:
            done = torch.cuda.Event()
            done.record()
        if self._pending is not None:
            self._absorb()
        self._pending = (keys, host, done)
        self.n += 1

    def result(self, counters=COUNTER_KEYS):
        if self._pending is not None:
            self._absorb()
        return {k: (v if k in counters else v / max(self.n, 1))
                for k, v in self.sums.items()}


class Trainer:
    """Generic fit loop around plain step functions.

    train_step(model, opt_state, batch, generator) -> (opt_state, metrics)
    eval_step(model, batch, generator) -> metrics  (may contain score_key)
    artifact_fn(model, batch) -> (src, pred, tar, gt_src) of one sample

    With a ``mesh`` the steps also take ``mesh=``, the mesh their batch
    runs under (module docstring).
    """

    def __init__(self, train_step: Callable, eval_step: Optional[Callable],
                 cfg: FitConfig, score_key: str = "loss",
                 score_mode: str = "min",
                 artifact_fn: Optional[Callable] = None, device=None, mesh=None):
        self.train_step = train_step
        self.eval_step = eval_step
        self.cfg = cfg
        self.score_key = score_key
        self.score_mode = score_mode
        self.artifact_fn = artifact_fn
        self.device = _device.resolve(device)
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0  # the rank that writes files
        os.makedirs(cfg.exp_dir, exist_ok=True)
        self.writer = (MetricsWriter(os.path.join(cfg.exp_dir, "logs"),
                                     tensorboard=cfg.log_tensorboard) if self.lead else None)
        self.ckpt = CheckPointManager(
            os.path.join(cfg.exp_dir, "checkpoints"),
            max_to_keep=cfg.max_to_keep,
            keep_every_n_hours=cfg.keep_every_n_hours,
            best_mode="min" if score_mode == "min" else "max",
            use_async=cfg.async_checkpoints,
        )

    def _put(self, batch):
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _shard(self, batch):
        """(this rank's rows of the batch on the device, the steps' keyword
        arguments: the mesh it runs under)."""
        batch = self._put(batch)
        if self.mesh is None:
            return batch, {}
        mesh = self.mesh.for_rows(next(v.shape[0] for v in batch.values() if v.dim()))
        return PM.shard_batch(batch, mesh), {"mesh": mesh}

    def _dp_mean(self, metrics: dict) -> dict:
        """The epoch's metrics averaged over the dp group: every rank holds
        its rows' estimate of each batch's value."""
        if self.mesh is None or self.mesh.dp == 1 or not metrics:
            return metrics
        keys = sorted(metrics)
        mean = self.mesh.dp_mean(torch.tensor([metrics[k] for k in keys], dtype=torch.float64))
        return dict(zip(keys, mean.tolist()))

    def _generator(self, *parts):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_epoch_seed(self.cfg.seed, *parts))
        return gen

    def restore(self, model, opt_state):
        """Reload-latest when resume is on: loads the model's state in place.
        Returns (opt_state, start_epoch)."""
        if not self.cfg.resume:
            return opt_state, 0
        target = {"params": model.state_dict(), "opt_state": opt_state, "epoch": 0}
        state, _ = self.ckpt.load(target)
        if state is None:
            return opt_state, 0
        model.load_state_dict(state["params"])
        return state["opt_state"], int(state["epoch"]) + 1

    def fit(self, model, opt_state, train_loader, test_loader=None,
            epochs: Optional[int] = None, log=print):
        """Train ``model`` in place from the latest checkpoint (if any) to
        ``epochs``. Returns (model, opt_state, history), history one record
        per epoch run: the train aggregates and the eval ones as
        ``test_{key}``."""
        cfg = self.cfg
        epochs = cfg.epochs if epochs is None else epochs
        if debug.nan_checks_on():
            debug.name_modules(model)
        opt_state, start = self.restore(model, opt_state)
        history = []
        for epoch in range(start, epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            gen = self._generator(epoch)
            t0 = time.perf_counter()
            agg = _EpochMetrics()
            for batch in train_loader:
                batch, kw = self._shard(batch)
                opt_state, metrics = self.train_step(model, opt_state, batch, gen, **kw)
                agg.push(metrics)
            train_metrics = self._dp_mean(agg.result())
            if self.lead:
                self.writer.add_scalars(train_metrics, epoch, prefix="train/")

            eval_metrics = {}
            if self.eval_step is not None and test_loader is not None:
                egen = self._generator(epoch, 1_000_000)
                eagg = _EpochMetrics()
                with torch.no_grad():
                    for batch in test_loader:
                        batch, kw = self._shard(batch)
                        eagg.push(self.eval_step(model, batch, egen, **kw))
                eval_metrics = self._dp_mean(eagg.result(counters=()))
                if self.lead:
                    self.writer.add_scalars(eval_metrics, epoch, prefix="test/")

            score = eval_metrics.get(self.score_key,
                                     train_metrics.get(self.score_key))
            history.append({"epoch": epoch, **train_metrics,
                            **{f"test_{k}": v for k, v in eval_metrics.items()}})
            if not self.lead:
                continue
            if cfg.save_every and epoch % cfg.save_every == 0:
                self.ckpt.save(
                    epoch,
                    {"params": model.state_dict(), "opt_state": opt_state, "epoch": epoch},
                    score=score,
                )
            if (cfg.artifacts_every and self.artifact_fn is not None
                    and epoch % cfg.artifacts_every == 0):
                with torch.no_grad():
                    clouds = to_host(self.artifact_fn(model, self._put(next(iter(train_loader)))))
                dump_registration_objs(os.path.join(cfg.exp_dir, "artifacts"),
                                       f"ep{epoch}", *clouds)
            dt = time.perf_counter() - t0
            self.writer.add_scalar("time/epoch_seconds", dt, epoch)
            self.writer.flush()
            log(f"epoch {epoch}: "
                + " ".join(f"{k}={v:.6f}" for k, v in train_metrics.items())
                + (" | test: " + " ".join(
                    f"{k}={v:.6f}" for k, v in eval_metrics.items())
                   if eval_metrics else "")
                + f" ({dt:.1f}s)")
        self.ckpt.wait_until_finished()  # commit any in-flight async save
        if self.mesh is not None:
            self.mesh.barrier()  # no rank restores before rank 0's files are written
        return model, opt_state, history


def add_mesh_flags(ap):
    """The JAX CLI's ``--dp`` and ``--sp``."""
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks (0 = one process); with --sp, dp x sp ranks "
                         "on this host (spawned, or torchrun's) shard each batch over dp")
    ap.add_argument("--sp", type=int, default=1,
                    help="line-parallel ranks: each sweeps its share of the metric's "
                         "lines (see parallel/mesh.py); training only, --eval_only runs "
                         "in one process")


def mesh_shape(args, ap):
    """(dp, sp) of ``--dp`` / ``--sp`` as the JAX CLIs read them (``--dp 0``
    and ``--sp 1``: no mesh, None; otherwise dp is ``--dp`` or 1), or None
    for ``--eval_only``; exits on a value below its minimum."""
    if args.dp < 0 or args.sp < 1:
        ap.error(f"--dp must be >= 0 and --sp >= 1 (got --dp {args.dp} --sp {args.sp})")
    if args.eval_only or not (args.dp or args.sp > 1):
        return None
    return args.dp or 1, args.sp


def with_mesh(cfg, mesh):
    """A trainer config (one with a ``loss``) whose loss config runs under
    ``mesh``; cfg itself where mesh is None."""
    if mesh is None:
        return cfg
    return dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, mesh=mesh))


def run_cli(parser: Callable, argv, run: Callable):
    """A trainer CLI's body: the flags of ``parser()`` read from argv (the
    command line when None), then ``run(args, ap)`` in this process under
    the ``--debug_nans`` / ``--debug`` scope; or, with a mesh
    (``mesh_shape``), ``run(args, ap, mesh)`` on each of dp x sp ranks
    through ``parallel.mesh.launch``, which returns None when it spawned
    them. ``parser`` and ``run`` are module-level functions: a spawned rank
    imports them by name."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = parser()
    args = ap.parse_args(argv)
    shape = mesh_shape(args, ap)
    if shape is None:
        with debug_scope(args):
            return run(args, ap)
    return PM.launch(_cli_rank, *shape, args=(parser, run, argv), device=args.device)


def _cli_rank(mesh, parser, run, argv):
    ap = parser()
    args = ap.parse_args(argv)
    with debug_scope(args):
        return run(args, ap, mesh)


def add_precision_and_debug_flags(ap):
    """The JAX CLI's ``--dtype``, ``--debug_nans`` and ``--debug``."""
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="the model's compute dtype (bfloat16: mixed precision; the "
                         "parameters, the norms' statistics, the SVD and the metric stay "
                         "fp32)")
    ap.add_argument("--debug_nans", action="store_true",
                    help="raise FloatingPointError at a NaN in a module's output, the "
                         "loss or a backward node (autograd anomaly mode)")
    ap.add_argument("--debug", action="store_true",
                    help="--debug_nans and a pdb post-mortem on FloatingPointError or "
                         "RuntimeError")


def debug_scope(args):
    """The NaN checks of ``--debug_nans`` / ``--debug`` on inside the
    returned context (``utils/debug.py``), and with ``--debug`` the pdb
    excepthook installed, as the JAX CLIs do."""
    if args.debug:
        debug.install_pdb_excepthook()
    return debug.anomaly_detection(args.debug_nans or args.debug)
