"""Data and line parallelism on ``torch.distributed``: the (dp, sp) mesh.

Port of ``a_robust_registration_loss_tpu/parallel/mesh.py``. There a named
``jax.sharding.Mesh`` lets GSPMD place the collectives; here each rank is a
process, and the collectives are written out:

- ``dp`` splits the batch. Rank r holds rows ``dp_rank * B/dp`` to
  ``(dp_rank + 1) * B/dp`` of every leaf whose leading axis divides by dp
  (``shard_batch``); the trainers average the gradients, the loss and the
  epoch metrics over the dp group (``train/harness.py``).
- ``sp`` splits the metric's line axis. Lines are i.i.d., so stage 1 sweeps
  only this rank's ``L/sp`` lines (``line_shard``); its per-line slot
  records are gathered over the sp group in sp order (``gather_lines``) and
  stage 2, whose exact median couples every line of a sample, runs on each
  sp member (``train/losses.py:_metric_batch_rt_sp``).

Rank r sits at ``(r // sp, r % sp)``, row-major, as the JAX package's
``np.asarray(devices).reshape(dp, sp)`` places devices.

The gradient of line parallelism is a conjugate pair of autograd
functions. ``gather_lines``' backward returns this rank's slice of the
cotangent and sums nothing: every sp member runs stage 2 on the same
tensors, so the cotangents of the gathered records are equal on all of them
(``torch.distributed.nn.functional.all_gather`` would sum them, multiplying
the gradient by sp). ``sp_reduce`` is the identity whose backward sums the
cotangent over the sp group: put on the (R, t) that enter the metric, it
gives every sp member the metric's whole gradient from its own share. The
loss terms that every sp member computes whole (DCP's cycle loss, FMR's AE
loss, RPM-Net's outlier term) are then counted once, and the parameters
need no sum over sp.

Processes: ``launch`` runs a function on dp x sp ranks of one host, joining
the world from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) or, without it, spawning the ranks itself, under an
optional time limit on the whole world, and can hand back each rank's
result. The backend is
NCCL when every rank of the host has a card of its own and gloo when ranks
share a card or run on the CPU; gloo's collectives on CUDA tensors are
staged through the host here. Every collective has the process group's
timeout: one that hangs fails its rank, and a failed rank fails the run.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0  # a collective waits this long before its rank fails


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, sp) mesh and the process groups of its
    dp column and sp row (None where that axis is 1). ``device`` is where
    the backend takes tensors: the CPU for gloo, this rank's card for
    NCCL."""

    dp: int
    sp: int
    rank: int
    dp_rank: int
    sp_rank: int
    dp_group: Optional[object]
    sp_group: Optional[object]
    device: torch.device

    def for_rows(self, rows: int) -> "Mesh":
        """The mesh a batch of ``rows`` rows runs under: this one where
        rows divide by dp, else the same sp row with dp = 1, the batch whole
        on every dp rank and nothing summed over dp (the last, smaller batch
        of an epoch; batch-1 loaders)."""
        if rows % self.dp == 0:
            return self
        return dataclasses.replace(self, dp=1, dp_rank=0, dp_group=None)

    def _comm(self, x):
        """A contiguous copy of ``x`` where the backend takes it."""
        return x.detach().to(self.device, copy=True).contiguous()

    def all_reduce(self, x, group):
        """The sum of ``x`` over ``group``, on x's device."""
        y = self._comm(x)
        dist.all_reduce(y, group=group)
        return y.to(x.device)

    def all_gather(self, x, group, size: int, dim: int):
        """``x`` of every rank of ``group`` (``size`` ranks, all of x's
        shape) concatenated along ``dim`` in group order, on x's device."""
        y = self._comm(x)
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    def dp_mean(self, x):
        """The mean of ``x`` over the dp group (``x`` where dp is 1)."""
        if self.dp == 1:
            return x
        return self.all_reduce(x, self.dp_group) / self.dp

    def dp_gather(self, x):
        """Every dp rank's ``x`` concatenated along the leading axis, in dp
        order: the global batch's rows."""
        if self.dp == 1:
            return x
        return self.all_gather(x, self.dp_group, self.dp, 0)

    def barrier(self):
        """Wait for every rank of the world (a one-element all-reduce, which
        every backend takes)."""
        self.all_reduce(torch.zeros(1), None)


def make_mesh(dp: int = 1, sp: int = 1) -> Mesh:
    """A (dp, sp) mesh over the initialised ``torch.distributed`` world.
    dp * sp must be the world size. Every rank creates the process group of
    every sp row and then of every dp column, in the same order, and keeps
    its own two."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised (see launch)")
    world = dist.get_world_size()
    if dp < 1 or sp < 1 or dp * sp != world:
        raise ValueError(f"dp*sp == {dp * sp} != {world} ranks")
    rank = dist.get_rank()
    dp_rank, sp_rank = divmod(rank, sp)
    sp_group = dp_group = None
    if sp > 1:
        for i in range(dp):
            g = dist.new_group([i * sp + j for j in range(sp)])
            if i == dp_rank:
                sp_group = g
    if dp > 1:
        for j in range(sp):
            g = dist.new_group([i * sp + j for i in range(dp)])
            if j == sp_rank:
                dp_group = g
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(dp, sp, rank, dp_rank, sp_rank, dp_group, sp_group, device)


def dp_rows(x, mesh: Mesh):
    """This rank's dp rows of ``x``, whose leading axis divides by dp."""
    n = x.shape[0] // mesh.dp
    return x[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's dp rows of every leaf whose leading axis divides by dp;
    the other leaves whole (replicated), as the JAX package's
    ``shard_batch`` places them."""
    return {k: (dp_rows(v, mesh) if getattr(v, "ndim", 0) >= 1 and v.shape[0] % mesh.dp == 0
                else v)
            for k, v in batch.items()}


def line_shard(lines, mesh: Mesh):
    """This rank's L/sp lines of (..., L, 6) lines, in sp order. Raises
    when L does not divide by sp, as ``shard_map`` refuses there."""
    L = lines.shape[-2]
    if L % mesh.sp:
        raise ValueError(f"line_shard: {L} lines do not divide by sp = {mesh.sp}")
    n = L // mesh.sp
    return lines.narrow(-2, mesh.sp_rank * n, n)


class _GatherLines(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, mesh.sp_group, mesh.sp, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.sp_rank * ctx.n, ctx.n), None, None


def gather_lines(x, mesh: Mesh, dim: int = 1):
    """The line shards of every sp member concatenated along ``dim``, in sp
    order. The backward returns this rank's slice of the cotangent and sums
    nothing (see the module docstring)."""
    if mesh.sp == 1:
        return x
    return _GatherLines.apply(x, mesh, dim)


class _SpReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.mesh.sp_group), None


def sp_reduce(x, mesh: Mesh):
    """The identity, whose backward sums the cotangent over the sp group."""
    if mesh.sp == 1:
        return x
    return _SpReduce.apply(x, mesh)


def init_process(rank: int, world: int, init_method: str, local_rank: int, local_world: int,
                 device: str = "cuda", timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the world as ``rank`` and return this rank's device: on a card,
    ``cuda:(local_rank % device_count)``, made current; a rank that finds no
    card raises. The backend is NCCL when every one of the host's
    ``local_world`` ranks has a card of its own, gloo when ranks share a
    card or run on the CPU."""
    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device is available")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if local_world <= torch.cuda.device_count():
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _rank_main(local_rank, world, init_method, dp, sp, device, timeout_s, fn, workdir, results):
    args = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
    init_process(local_rank, world, init_method, local_rank, world, device, timeout_s)
    try:
        out = fn(make_mesh(dp, sp), *args)
        if results:
            torch.save(out, os.path.join(workdir, f"rank{local_rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, dp: int, sp: int, args: tuple = (), device: str = "cuda",
           timeout_s: float = TIMEOUT_S, join_s: Optional[float] = None,
           workdir: Optional[str] = None, results: bool = False):
    """Run ``fn(mesh, *args)`` on dp x sp ranks of this host.

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) this process is one
    rank: it joins the world and returns fn's result. Otherwise it spawns
    the dp x sp ranks (spawn start method) and waits for them, at most
    ``join_s`` seconds where that is given. The rendezvous file and ``args``
    lie in a temporary directory under ``workdir`` (the system's temporary
    directory by default); the arguments go through a file because a spawn
    pipe that fills blocks each start until the last rank has read its
    own. Returns the list of the ranks' results by rank where ``results``
    (each saved to that directory), else None. A rank that raises or dies,
    or a world not done in ``join_s``, makes it raise, after the other
    ranks are stopped. ``fn`` must pickle (a module-level function)."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if dp * sp != world:
            raise ValueError(f"dp*sp == {dp * sp} != WORLD_SIZE {world}")
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        init_process(int(os.environ["RANK"]), world, "env://", local_rank,
                     int(os.environ.get("LOCAL_WORLD_SIZE", world)), device, timeout_s)
        try:
            return fn(make_mesh(dp, sp), *args)
        finally:
            dist.destroy_process_group()
    world = dp * sp
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world, "file://" + os.path.join(tmp, "rendezvous"), dp, sp, device,
                              timeout_s, fn, tmp, results),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if join_s is None else time.monotonic() + join_s
        try:
            while not ctx.join(None if deadline is None
                               else max(0.1, deadline - time.monotonic())):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks not done in {join_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        if results:
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]
    return None
