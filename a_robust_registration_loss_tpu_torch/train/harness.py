"""The trainers' shared runtime: a guarded Adam step and the epoch loop.

Port of ``a_robust_registration_loss_tpu/train/harness.py``. ``Trainer.fit``
runs a train step per batch, logs epoch aggregates through
``utils.MetricsWriter``, evaluates, checkpoints through
``utils.CheckPointManager`` and dumps OBJ artifacts, resuming from the
latest checkpoint. It has the JAX harness's two paths:

- streaming: it iterates a loader, one eager step a batch, each batch's
  metrics read one batch behind (``_EpochMetrics``);
- the scanned epoch (the JAX ``_train_epoch_fn`` / ``_eval_epoch_fn``):
  over a ``DeviceCache`` (``DeviceCache.next_epoch``), each full batch is
  gathered on the device from a static index row, its uniforms drawn from
  the epoch's generator into a static buffer, the step replayed from CUDA
  graphs on the card (``train/graphs.py``; on the CPU the same
  static-buffer steps run eagerly), its metrics stacked on the device and
  fetched once an epoch (``_reduce_stacked``). A trainer opts in by giving
  its steps as ``Split``s: the step cut at the solves that read the host
  (the SVDs), which stay eager between the captured pieces. Train and eval
  epochs both, eval under ``torch.no_grad``. The remainder batch of a
  ``drop_last=False`` cache runs eagerly, as in the JAX harness.

  The scanned epoch is not taken under a mesh (gloo's host-staged
  collectives cannot be captured) or with the NaN checks of
  ``--debug_nans`` on (they read the host): both stream.

The steps are plain functions on a ``torch.nn.Module`` that they update in
place: ``train_step(model, opt_state, batch, generator) -> (opt_state,
metrics)`` and ``eval_step(model, batch, generator) -> metrics``, metrics a
dict of 0-d device tensors. Randomness comes from one ``torch.Generator`` an
epoch, seeded from ``(FitConfig.seed, epoch)`` (eval's from ``(seed, epoch,
1_000_000)``), the role of the JAX package's ``fold_in(root_key, epoch)``: a
run killed after a checkpoint and resumed reproduces the losses of an
uninterrupted one. Both paths draw the same uniforms in the same order, so
their losses are equal.

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
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.data import objio
from a_robust_registration_loss_tpu_torch.ops import adam
from a_robust_registration_loss_tpu_torch.ops.adam import AdamState, ScheduledAdamState
from a_robust_registration_loss_tpu_torch.parallel import mesh as PM
from a_robust_registration_loss_tpu_torch.train import graphs
from a_robust_registration_loss_tpu_torch.utils import CheckPointManager, MetricsWriter
from a_robust_registration_loss_tpu_torch.utils import debug
from a_robust_registration_loss_tpu_torch.utils.checkpoint import to_host
from a_robust_registration_loss_tpu_torch.utils.timing import span

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


class Split(NamedTuple):
    """A step cut at the solves that read the host, for the scanned epoch:
    the ``pieces`` are captured (``graphs.Segment``), ``solve`` runs
    eagerly between each two. ``run_split`` runs them all eagerly, and the
    trainers' steps are that run.

    pieces[0](model, batch, u4) -> tuple of tensors
    solve(model, tuple) -> tuple of tensors, between each two pieces
    pieces[k](model, batch, u4, tuple) -> tuple, for 0 < k < the last; the
        last returns (loss, metrics) for a train step (one with an
        ``update``), metrics for an eval step
    lines(batch_size) -> the shape of the uniforms a batch draws, or None
        for a step that draws none
    update(grads, opt_state, params, loss) -> (opt_state, nonfinite flag)
    """
    pieces: tuple
    solve: Callable
    lines: Optional[Callable] = None
    update: Optional[Callable] = None


def draw(split: Split, batch, generator):
    """The uniforms one batch of ``split`` draws from ``generator``, or
    None."""
    if split.lines is None:
        return None
    x = next(v for v in batch.values() if v.dim())
    return torch.rand(split.lines(x.shape[0]), generator=generator, device=x.device)


def run_split(split: Split, model, batch, u4, opt_state=None):
    """One step of ``split``, eagerly: with an update, the gradient of the
    loss to every parameter and the update in place, returning (opt_state,
    metrics + ``loss`` and ``nonfinite_steps``); without, the metrics."""
    with span("arrl.step.forward"):
        out = split.pieces[0](model, batch, u4)
    for piece in split.pieces[1:]:
        with span("arrl.step.solve"):
            solved = split.solve(model, out)
        with span("arrl.step.forward"):
            out = piece(model, batch, u4, solved)
    if split.update is None:
        return out
    loss, metrics = out
    params = list(model.parameters())
    with span("arrl.step.backward"):
        grads = debug.grad(loss, params, allow_unused=True)
    loss = loss.detach()
    with span("arrl.step.update"):
        opt_state, nonfinite = split.update(grads, opt_state, params, loss)
    return opt_state, dict(metrics, loss=loss, nonfinite_steps=nonfinite)


def _fetch(rows):
    """The one device-to-host read of a scanned epoch's stacked metrics."""
    return rows.cpu().tolist()


def _reduce_stacked(keys, rows, counters=COUNTER_KEYS):
    """An epoch's per-batch metric rows (values in ``keys`` order) -> its
    aggregates, on both paths: counters summed, the rest averaged, in
    float64 in batch order."""
    sums = {}
    for row in rows:
        for k, v in zip(keys, row):
            sums[k] = sums.get(k, 0.0) + v
    return {k: (v if k in counters else v / max(len(rows), 1)) for k, v in sums.items()}


class _Scan:
    """One ``Split``'s steps over a ``DeviceCache``'s full batches: the
    batch's index row copied into a static one, its uniforms drawn into a
    static buffer, then the step. The first step of a fit is eager on the
    run's own state and builds the rest: ``_GraphStep`` on the card,
    ``_EagerStep`` (the same static buffers, the split run eagerly) on the
    CPU."""

    def __init__(self, split: Split, model, cache, batch_size: int):
        self.split, self.model, self.cache = split, model, cache
        dev = cache.device
        self.idx = torch.zeros(batch_size, dtype=torch.int64, device=dev)
        self.u4 = (None if split.lines is None
                   else torch.empty(split.lines(batch_size), device=dev))
        self.step = None

    def __call__(self, row, generator, opt_state=None):
        self.idx.copy_(row)
        if self.u4 is not None:
            torch.rand(self.u4.shape, generator=generator, device=self.u4.device, out=self.u4)
        if self.step is not None:
            return self.step(opt_state)
        out = run_split(self.split, self.model, self.cache.gather(self.idx), self.u4, opt_state)
        self.step = (_GraphStep if self.idx.is_cuda else _EagerStep)(
            self.split, self.model, self.cache, self.idx, self.u4,
            out[0] if self.split.update else None)
        return out


class _EagerStep:
    """The scanned step on the CPU: the split run eagerly on the batch
    gathered from the static index row and the static uniforms."""

    def __init__(self, split, model, cache, idx, u4, opt_state):
        self.split, self.model, self.cache, self.idx, self.u4 = split, model, cache, idx, u4

    def __call__(self, opt_state):
        return run_split(self.split, self.model, self.cache.gather(self.idx), self.u4,
                         opt_state)


class _GraphStep:
    """The scanned step on the card, from CUDA graphs: the batch's gather,
    each piece (forward and backward) with the solves eagerly between
    them, and for a train step the update, captured with the Adam state and
    the parameters in static storage (``opt_state``, the state of the eager
    first step, updated in place). The parameters go from piece to piece as
    taps (``graphs.tap``), so the gradients add up as in the eager step.
    Every piece captures on its first call."""

    def __init__(self, split, model, cache, idx, u4, opt_state):
        # nothing here refers back to the step or its ``_Scan``: without a
        # cycle, the graphs and their pools go as soon as the scan does
        self.split, self.model, self.opt = split, model, opt_state
        self.params = params = list(model.parameters())
        names = [n for n, _ in model.named_parameters()]
        self.gather = graphs.Graph(lambda: cache.gather(idx), (idx,))
        batch = self.gather.out
        first, *rest = split.pieces
        n = len(params)

        def later(piece, last):
            def fn(*inputs):
                taps = inputs[len(inputs) - n:]
                with graphs.swapped(model, names, taps):
                    out = piece(model, batch, u4, inputs[:len(inputs) - n])
                return out if last else (out, graphs.tap(taps))
            return graphs.Segment(fn)

        self.pieces = [graphs.Segment(lambda: (first(model, batch, u4), graphs.tap(params)),
                                      params)]
        self.pieces += [later(piece, i == len(rest) - 1) for i, piece in enumerate(rest)]
        self.update = None

    def __call__(self, opt_state):
        split, model = self.split, self.model
        self.gather.replay()
        with span("arrl.step.forward"):
            out, taps = self.pieces[0]()
        for i, piece in enumerate(self.pieces[1:], 1):
            with span("arrl.step.solve"):
                solved = split.solve(model, out)
            with span("arrl.step.forward"):
                out = piece(*solved, *taps)
            if i < len(self.pieces) - 1:
                out, taps = out
        if split.update is None:
            return out
        loss, metrics = out
        with span("arrl.step.backward"):
            grads = debug.grad(loss, self.params, allow_unused=True)
        loss = loss.detach()
        with span("arrl.step.update"):
            graphs.copy_carry(self.opt, opt_state)  # nothing to copy unless an eager step ran
            nonfinite = self._update(grads, loss)
        return self.opt, dict(metrics, loss=loss, nonfinite_steps=nonfinite)

    def _update(self, grads, loss):
        present = [g is not None for g in grads]
        if self.update is None:
            self.present = present
            self.grads = [None if g is None else g.detach().clone() for g in grads]
            self.loss = loss.clone()

            update, grads, opt, params, loss = (self.split.update, self.grads, self.opt,
                                                self.params, self.loss)

            def body():
                state, nonfinite = update(grads, opt, params, loss)
                graphs.copy_carry(opt, state)
                return nonfinite

            self.update = graphs.Graph(body, (self.grads, self.loss, self.opt))
        else:
            if present != self.present:
                raise RuntimeError("the scanned step's unused parameters changed between steps")
            torch._foreach_copy_([s for s in self.grads if s is not None],
                                 [g for g in grads if g is not None])
            self.loss.copy_(loss)
        return self.update.replay()


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
    """One epoch's per-batch metrics on the host, one batch behind: each
    batch's metrics go to the host as one stacked tensor, copied without a
    wait, and are read only after the next batch's step has been queued, so
    the device never idles on the fetch. ``result`` reduces them as the
    scanned epoch does (``_reduce_stacked``)."""

    def __init__(self):
        self.keys, self.rows, self._pending = None, [], None

    def _absorb(self):
        host, done = self._pending
        if done is not None:
            done.synchronize()
        self.rows.append(host.tolist())
        self._pending = None

    def push(self, metrics):
        self.keys = sorted(metrics)
        stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in self.keys])
        host = stacked.to("cpu", non_blocking=True)
        done = None
        if stacked.is_cuda:
            done = torch.cuda.Event()
            done.record()
        if self._pending is not None:
            self._absorb()
        self._pending = (host, done)

    def result(self, counters=COUNTER_KEYS):
        if self._pending is not None:
            self._absorb()
        return _reduce_stacked(self.keys or [], self.rows, counters)


class Trainer:
    """Generic fit loop around plain step functions.

    train_step(model, opt_state, batch, generator) -> (opt_state, metrics)
    eval_step(model, batch, generator) -> metrics  (may contain score_key)
    artifact_fn(model, batch) -> (src, pred, tar, gt_src) of one sample

    With a ``mesh`` the steps also take ``mesh=``, the mesh their batch
    runs under (module docstring). ``train_split`` / ``eval_split``: the
    same steps as ``Split``s, which the scanned epoch over a
    ``DeviceCache`` runs; without one, that loader streams.
    """

    def __init__(self, train_step: Callable, eval_step: Optional[Callable],
                 cfg: FitConfig, score_key: str = "loss",
                 score_mode: str = "min",
                 artifact_fn: Optional[Callable] = None, device=None, mesh=None,
                 train_split: Optional[Split] = None, eval_split: Optional[Split] = None):
        self.train_step = train_step
        self.eval_step = eval_step
        self.splits = {"train": train_split, "eval": eval_split}
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

    def _scanned(self, name, loader) -> bool:
        """Whether ``loader``'s epoch is scanned: a ``DeviceCache`` and a
        split for the step, no mesh, the NaN checks off."""
        return (self.splits[name] is not None and hasattr(loader, "next_epoch")
                and self.mesh is None and not debug.nan_checks_on())

    def _scanned_epoch(self, scans, name, model, cache, gen, opt_state=None):
        """One scanned epoch over ``cache``: a ``_Scan`` step per full
        batch (built at the fit's first), the remainder batch through the
        streaming step, every batch's metrics stacked into one device
        tensor that is fetched once. Returns (opt_state, aggregates)."""
        train = name == "train"
        _, full, rem = cache.next_epoch()
        n = full.shape[0] + (rem is not None)
        keys = rows = None

        def keep(i, metrics):
            nonlocal keys, rows
            if rows is None:
                keys = sorted(metrics)
                rows = torch.empty((n, len(keys)), device=self.device)
            rows[i].copy_(torch.stack([metrics[k].detach().float().reshape(()) for k in keys]))

        for i in range(full.shape[0]):
            if name not in scans:
                scans[name] = _Scan(self.splits[name], model, cache, full.shape[1])
            out = scans[name](full[i], gen, opt_state)
            if train:
                opt_state, out = out
            keep(i, out)
        if rem is not None:
            batch = cache.gather(rem)
            if train:
                opt_state, metrics = self.train_step(model, opt_state, batch, gen)
            else:
                metrics = self.eval_step(model, batch, gen)
            keep(n - 1, metrics)
        if rows is None:
            return opt_state, {}
        return opt_state, _reduce_stacked(keys, _fetch(rows),
                                          COUNTER_KEYS if train else ())

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
        scans = {}  # the scanned epoch's steps and their graphs, for this fit
        for epoch in range(start, epochs):
            with span("arrl.fit.epoch"):
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch)
                gen = self._generator(epoch)
                t0 = time.perf_counter()
                with span("arrl.fit.train"):
                    if self._scanned("train", train_loader):
                        opt_state, train_metrics = self._scanned_epoch(
                            scans, "train", model, train_loader, gen, opt_state)
                    else:
                        agg = _EpochMetrics()
                        for batch in train_loader:
                            batch, kw = self._shard(batch)
                            opt_state, metrics = self.train_step(model, opt_state, batch, gen,
                                                                 **kw)
                            agg.push(metrics)
                        train_metrics = self._dp_mean(agg.result())
                if self.lead:
                    self.writer.add_scalars(train_metrics, epoch, prefix="train/")

                eval_metrics = {}
                if self.eval_step is not None and test_loader is not None:
                    egen = self._generator(epoch, 1_000_000)
                    with span("arrl.fit.eval"), torch.no_grad():
                        if self._scanned("eval", test_loader):
                            _, eval_metrics = self._scanned_epoch(scans, "eval", model,
                                                                  test_loader, egen)
                        else:
                            eagg = _EpochMetrics()
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
                    with span("arrl.fit.checkpoint"):
                        self.ckpt.save(
                            epoch,
                            {"params": model.state_dict(), "opt_state": opt_state,
                             "epoch": epoch},
                            score=score,
                        )
                if (cfg.artifacts_every and self.artifact_fn is not None
                        and epoch % cfg.artifacts_every == 0):
                    with torch.no_grad():
                        clouds = to_host(self.artifact_fn(model,
                                                          self._put(next(iter(train_loader)))))
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
        scans.clear()  # the graphs and their memory pools go with the fit
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
