"""The ranks of the port's multi-process tests (test_torch_parallel*.py).

A spawned rank imports this module by name, so it imports no JAX: the test
files compute the single-process and JAX references in the parent and
compare them with what each rank returned. ``launch`` starts the ranks
through ``parallel.mesh.launch`` on the CPU over gloo, with a ``file://``
rendezvous under the test's own temporary directory (xdist workers never
share a port) and a time limit on every collective and on the join. Each
world's body runs on one thread a rank.
"""

import dataclasses
import os
import time

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch.ops import adam
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.parallel import mesh as PM
from a_robust_registration_loss_tpu_torch.se3 import se3
from a_robust_registration_loss_tpu_torch.train import harness as H
from a_robust_registration_loss_tpu_torch.train import losses as LS

COLLECTIVE_S = 120.0  # each collective
JOIN_S = 240.0       # each world, start to finish


def launch(fn, dp: int, sp: int, tmp, args=(), device: str = "cpu"):
    """``parallel.mesh.launch`` of ``fn(mesh, *args)`` on a (dp, sp) world
    over gloo (on the CPU, or on the one card its ranks share), its
    rendezvous under ``tmp``, within the time limits above: the list of
    the ranks' results by rank."""
    return PM.launch(fn, dp, sp, args, device=device, timeout_s=COLLECTIVE_S, join_s=JOIN_S,
                     workdir=str(tmp), results=True)


def t(x, device="cpu"):
    return torch.tensor(np.asarray(x), device=device)


# ---------------------------------------------------------------------------
# inputs, made with the port's own functions from a seed
# ---------------------------------------------------------------------------

def problem(B=4, n=200, F=64, n_lines=256, seed=0):
    """B noisy unit-sphere pairs: FPS + 3-NN neighbourhoods, the target's
    box and centre, the global batch's uniforms and the lines
    ``batch_lines`` draws from them at radius scale 0.5, and B small twists
    with their row-convention (R, t). numpy arrays."""
    g = torch.Generator().manual_seed(seed)
    P = torch.randn(B, n, 3, generator=g)
    P = P / P.norm(dim=-1, keepdim=True)
    Q = P + 0.01 * torch.randn(B, n, 3, generator=g)
    twists = 0.03 * torch.randn(B, 6, generator=g)
    R, tt = se3.exp3(twists)
    u4 = torch.rand(B, 4, LN.ROUNDS * n_lines, generator=g)
    box = G.bounding_box_corners(Q)
    lines = LS.batch_lines(u4, box, Q.mean(1), n_lines, P, Q, 0.5)
    out = dict(src=P, tar=Q, tar_box=box, centers=Q.mean(1), u4=u4, lines=lines,
               n1=torch.stack([G.sample_neighs(p, F, 3).reshape(F, 9) for p in P]),
               n2=torch.stack([G.sample_neighs(q, F, 3).reshape(F, 9) for q in Q]),
               twists=twists, R=R, t=tt)
    return {k: v.numpy() for k, v in out.items()}


def metric_rt(p, mesh=None, device="cpu"):
    """``_metric_batch_rt`` on the problem's (R, t) and lines (this rank's
    rows and line shard under ``mesh``): (values, dR, dt) of the sum."""
    R, tt, n1, n2, lines = (t(p[k], device) for k in ("R", "t", "n1", "n2", "lines"))
    if mesh is not None:
        R, tt, n1, n2, lines = (PM.dp_rows(x, mesh) for x in (R, tt, n1, n2, lines))
        lines = PM.line_shard(lines, mesh)
    R.requires_grad_()
    tt.requires_grad_()
    v = LS._metric_batch_rt(R, tt, n1, n2, lines, LS.LossConfig(mesh=mesh))
    dR, dt = torch.autograd.grad(v.sum(), [R, tt])
    return v.detach(), dR, dt


def lines_under(p, mesh=None):
    """``batch_lines`` on the problem's inputs: this rank's rows and lines."""
    keys = ("tar_box", "centers", "src", "tar")
    box, c, s, q = (t(p[k]) if mesh is None else PM.dp_rows(t(p[k]), mesh) for k in keys)
    return LS.batch_lines(t(p["u4"]), box, c, p["lines"].shape[1], s, q, 0.5, mesh=mesh)


def classical_step(p, mesh=None, lr=1e-2, device="cpu"):
    """One full step of the batched classical objective, the port's
    counterpart of the JAX package's ``dryrun_multichip``: per-pair twists
    (their rows dp-sharded), the mean over the pairs of the rigid metric on
    the lines (sp-sharded), its gradient and Adam. Returns (the mean, the
    new twists of the whole batch)."""
    B = p["twists"].shape[0]
    tw, n1, n2, lines = (t(p[k], device) for k in ("twists", "n1", "n2", "lines"))
    if mesh is not None:
        tw, n1, n2, lines = (PM.dp_rows(x, mesh) for x in (tw, n1, n2, lines))
        lines = PM.line_shard(lines, mesh)
    tw.requires_grad_()
    R, tt = se3.exp3(tw)
    # this rank's share of the mean: its pairs' sum over the global B
    loss = LS._metric_batch_rt(R, tt, n1, n2, lines, LS.LossConfig(mesh=mesh)).sum() / B
    (g,) = torch.autograd.grad(loss, tw)
    keep = torch.ones(tw.shape[0], 1, dtype=torch.bool, device=device)
    new, _ = adam.step(lr, g, adam.init(tw.detach()), tw.detach(), keep)
    loss = loss.detach()
    if mesh is not None and mesh.dp > 1:
        loss, new = mesh.all_reduce(loss, mesh.dp_group), mesh.dp_gather(new)
    return float(loss), new


def dcp_loss_under(batch, R_ab, t_ab, u4, n_lines, mesh=None):
    """``dcp_cal_loss`` with the given uniforms: (loss, monitors) as floats,
    this rank's rows under ``mesh``."""
    data = {k: t(v) for k, v in batch.items()}
    R_ab, t_ab = t(R_ab), t(t_ab)
    if mesh is not None:
        data = PM.shard_batch(data, mesh)
        R_ab, t_ab = PM.dp_rows(R_ab, mesh), PM.dp_rows(t_ab, mesh)
    loss, mon = LS.dcp_cal_loss(data, R_ab, t_ab, LS.LossConfig(n_lines=n_lines, mesh=mesh),
                                u4=t(u4))
    return float(loss), {k: float(v) for k, v in mon.items()}


# ---------------------------------------------------------------------------
# the worlds of test_torch_parallel.py
# ---------------------------------------------------------------------------

def _members(mesh, group, size):
    if size == 1:
        return [mesh.rank]
    return mesh.all_gather(torch.tensor([mesh.rank]), group, size, 0).tolist()


def basics2(mesh, p, dcp_batch, dcp_R, dcp_t, dcp_u4, dcp_lines):
    """A world of 2, launched under (1, 2): (1, 2) and (2, 1)."""
    torch.set_num_threads(1)
    out = {}
    m = mesh
    B, Ls = 2, 3
    x = (torch.arange(B * Ls * 2.0).reshape(B, Ls, 2) + 100 * m.sp_rank).requires_grad_()
    w = torch.arange(B * Ls * 2 * 2.0).reshape(B, 2 * Ls, 2)
    y = PM.gather_lines(x, m)
    (ours,) = torch.autograd.grad((y * w).sum(), x)
    from torch.distributed.nn.functional import all_gather

    (theirs,) = torch.autograd.grad((torch.cat(all_gather(x, group=m.sp_group), 1) * w).sum(),
                                    x)
    out["gather"] = dict(y=y.detach(), ours=ours, theirs=theirs, w=w)
    for shape in ((1, 2), (2, 1)):
        m = mesh if shape == (mesh.dp, mesh.sp) else PM.make_mesh(*shape)
        out[shape] = dict(lines=lines_under(p, m), metric=metric_rt(p, m),
                          dcp=dcp_loss_under(dcp_batch, dcp_R, dcp_t, dcp_u4, dcp_lines, m))
    for bad in ((3, 1), (2, 2)):
        try:
            PM.make_mesh(*bad)
        except ValueError as e:
            out[bad] = str(e)
    try:
        PM.line_shard(torch.zeros(1, 7, 6), mesh)
    except ValueError as e:
        out["odd_lines"] = str(e)
    return out


def basics4(mesh, p):
    """A world of 4, launched under (2, 2): every factorisation."""
    torch.set_num_threads(1)
    out = {}
    leaves = {"rows": torch.arange(8).reshape(4, 2), "odd": torch.arange(3),
              "scalar": torch.tensor(5.0)}
    for shape in ((1, 4), (2, 2), (4, 1)):
        m = mesh if shape == (mesh.dp, mesh.sp) else PM.make_mesh(*shape)
        out[shape] = dict(
            place=(m.rank, m.dp_rank, m.sp_rank), sp_members=_members(m, m.sp_group, m.sp),
            dp_members=_members(m, m.dp_group, m.dp), shard=PM.shard_batch(leaves, m),
            lines=lines_under(p, m), step=classical_step(p, m))
    return out


# ---------------------------------------------------------------------------
# the worlds of test_torch_parallel_train.py
# ---------------------------------------------------------------------------

LR = 1e-6  # Adam turns a gradient near 0 into a step of +-lr of noisy sign
N_LINES = 128


def trainer(name):
    """(the trainer's module, a small config of it): DCP with the cycle
    term, FMR (its AE term), RPM-Net (its outlier term)."""
    if name == "dcp":
        from a_robust_registration_loss_tpu_torch.models.dcp import DCPConfig
        from a_robust_registration_loss_tpu_torch.train import dcp as mod

        return mod, mod.DCPTrainConfig(
            lr=LR, loss=LS.LossConfig(n_lines=N_LINES, cycle=True),
            model=DCPConfig(emb_nn="pointnet", emb_dims=32, n_heads=2, ff_dims=64, cycle=True))
    if name == "fmr":
        from a_robust_registration_loss_tpu_torch.models.fmr import FMRConfig
        from a_robust_registration_loss_tpu_torch.train import fmr as mod

        return mod, mod.FMRTrainConfig(lr=LR, train_maxiter=3, eval_maxiter=3,
                                       loss=LS.LossConfig(n_lines=N_LINES),
                                       model=FMRConfig(dim_k=32, num_points=48))
    from a_robust_registration_loss_tpu_torch.models.rpmnet import RPMNetConfig
    from a_robust_registration_loss_tpu_torch.train import rpmnet as mod

    return mod, mod.RPMTrainConfig(max_lr=LR, loss=LS.LossConfig(n_lines=N_LINES),
                                   model=RPMNetConfig(feat_dim=16, num_neighbors=8,
                                                      num_sk_iter=2, radius=0.5))


def steps(name, batch, mesh=None, n=2, handed=None, lr=LR):
    """n training steps from the seed-0 weights on ``batch`` (this rank's
    rows of it under the mesh its size allows). Returns each step's
    metrics, Adam's moments and count, and the lines ``batch_lines``
    drew (this rank's); the first step's ``batch_lines`` inputs; under a
    mesh, ``replayed``: ``batch_lines`` on one process's first-step inputs
    (this rank's rows of them); then the parameters.

    ``handed``: one process's (lines of each step, whole; first-step
    ``batch_lines`` inputs). The steps take those lines in place of the
    ones they draw. Two things part a mesh's lines from one process's: the
    gradient, summed in another order, may move an ulp of a parameter, and
    a library product may round a sample otherwise in a batch of another
    size (RPM-Net's annealing MLP on (B, 1024) on the CPU; on the card
    cuBLAS picks its kernels by shape); an ulp of the predicted source's
    box then moves the resampler's knife-edge labels, and one flipped
    candidate shifts every later line."""
    mod, cfg = trainer(name)
    cfg = dataclasses.replace(cfg, **{"max_lr" if name == "rpm" else "lr": lr})
    model = mod.init_model(cfg, 0, "cpu")
    opt = (H.scheduled_adam_init if name == "rpm" else H.adam_init)(model.parameters())
    gen = torch.Generator().manual_seed(5)
    data = {k: t(v) for k, v in batch.items()}
    if mesh is not None:
        mesh = mesh.for_rows(data["points_src_sample"].shape[0])
        data = PM.shard_batch(data, mesh)
    cfg = H.with_mesh(cfg, mesh)
    real = LS.batch_lines
    out, inputs, replayed = [], [], None
    if mesh is not None and handed is not None:
        (u4, *rest), kw = handed[1]
        rest = [PM.dp_rows(a, mesh) if torch.is_tensor(a) else a for a in rest]
        replayed = real(u4, *rest, mesh=mesh, **kw)
    for i in range(n):
        seen = []

        def lines(*args, **kw):
            if not inputs:
                inputs.append((list(args), {k: v for k, v in kw.items() if k != "mesh"}))
            seen.append(real(*args, **kw))
            if handed is None:
                return seen[-1]
            got = handed[0][i]
            return got if mesh is None else PM.line_shard(PM.dp_rows(got, mesh), mesh)

        LS.batch_lines = lines
        try:
            opt, m = mod.train_step(model, opt, data, cfg, generator=gen)
        finally:
            LS.batch_lines = real
        state = opt.adam if name == "rpm" else opt
        out.append(dict(metrics={k: float(v) for k, v in m.items()}, mu=state.mu.clone(),
                        nu=state.nu.clone(), count=int(state.count), lines=seen[0]))
    out[0].update(inputs=inputs[0], replayed=replayed)
    return out, {k: v.clone() for k, v in model.state_dict().items()}


def train_steps2(mesh, batches, handed):
    """A world of 2, launched under (2, 1): each trainer under (2, 1) and
    (1, 2) on the ``handed`` lines; a NaN on one dp rank; a batch whose
    size does not divide by dp."""
    torch.set_num_threads(1)
    out = {}
    for shape in ((2, 1), (1, 2)):
        m = mesh if shape == (mesh.dp, mesh.sp) else PM.make_mesh(*shape)
        for name in ("dcp", "fmr", "rpm"):
            out[name, shape] = steps(name, batches[name], m, handed=handed[name])
    out["nan"] = steps("dcp", batches["dcp_nan"], mesh, n=1)
    out["odd"] = steps("dcp", batches["dcp_odd"], mesh)
    return out


def fit(train_batches, test_batches, exp_dir, epochs, mesh=None, lr=LR):
    """``train.dcp.train`` on lists of batches (the last one smaller): the
    history."""
    mod, cfg = trainer("dcp")
    cfg = dataclasses.replace(cfg, lr=lr, fit=H.FitConfig(epochs=epochs, exp_dir=exp_dir,
                                                          log_tensorboard=False))
    return mod.train(cfg, train_batches, test_batches, device="cpu", mesh=mesh)[2]


def _no_tensorboard():
    from a_robust_registration_loss_tpu_torch.utils import logging as ulog

    ulog._try_tensorboard = lambda logdir: None


def fit_and_clis2(m, train_batches, test_batches, tmp, clis):
    """A world of 2 under (2, 1): ``Trainer.fit`` for 1 epoch, its resume to
    2, an uninterrupted 2-epoch run and one at lr 0; then each CLI with
    ``--dp 2`` (the rank's body of ``harness.run_cli``)."""
    torch.set_num_threads(1)
    _no_tensorboard()
    out = {"first": fit(train_batches, test_batches, os.path.join(tmp, "a"), 1, m),
           "resumed": fit(train_batches, test_batches, os.path.join(tmp, "a"), 2, m),
           "whole": fit(train_batches, test_batches, os.path.join(tmp, "b"), 2, m),
           "frozen": fit(train_batches, test_batches, os.path.join(tmp, "c"), 2, m, lr=0.0)}
    for name, argv in clis.items():
        mod = {"dcp": "dcp", "fmr": "fmr", "rpm": "rpmnet"}[name]
        mod = __import__(f"a_robust_registration_loss_tpu_torch.train.{mod}", fromlist=["_run"])
        out[name] = H._cli_rank(m, mod._parser, mod._run, argv)[2]
    return out


def touch_then_fail(mesh, directory):
    """A rank body for ``launch``: writes rank{r} with its place, then rank
    1 raises."""
    with open(os.path.join(directory, f"rank{mesh.rank}"), "w") as f:
        f.write(f"{mesh.dp} {mesh.sp} {mesh.dp_rank} {mesh.sp_rank}")
    mesh.barrier()
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")


def hang(mesh, directory):
    """A rank body for ``launch``: writes pid{r}, then never ends."""
    with open(os.path.join(directory, f"pid{mesh.rank}"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(3600)


def place(mesh):
    return mesh.rank, mesh.dp, mesh.sp


def card_sp2(m, p):
    """A world of 2 sharing one card over gloo, under (1, 2): the rigid
    metric and one classical step, and the lines of each stage-1 launch."""
    from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
    from a_robust_registration_loss_tpu_torch.ops.cuda import rigid_loss as RL

    swept, real = [], IK.stage1

    def counted(neis, lines, *args, **kw):
        swept.append(lines.shape[-2])
        return real(neis, lines, *args, **kw)

    IK.stage1 = counted
    try:
        IK.launches.clear()
        RL.launches.clear()
        v, dR, dt = metric_rt(p, m, device="cuda")
        loss, new = classical_step(p, m, device="cuda")
        torch.cuda.synchronize()
    finally:
        IK.stage1 = real
    return dict(v=v.cpu(), dR=dR.cpu(), dt=dt.cpu(), loss=loss, new=new.cpu(), swept=swept,
                launches=sum(IK.launches.values()), rigid_launches=sum(RL.launches.values()))
