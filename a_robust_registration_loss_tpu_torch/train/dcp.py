"""Unsupervised DCP training and evaluation, and its CLI.

Port of ``a_robust_registration_loss_tpu/train/dcp.py``: the DCP network
trained with the intersected-line metric. ``train_step``
(forward, ``dcp_train_loss``, autograd to every parameter, the guarded Adam
step at lr 1e-6), ``pretrain_step`` (an optional supervised phase on the
ground truth, ``gt_consistency_loss`` at lr 1e-4), ``train`` (both phases
on ``train.harness.Trainer``, each with a fresh optimiser, ``Loader``s
cached on the card through ``maybe_device_cache``), the evaluation path
(``eval_step``, ``artifact_fn`` and ``evaluate``) and ``main``:

    python -m a_robust_registration_loss_tpu_torch.train.dcp \
        --data_path DIR --exp_dir EXP [--emb_nn pointnet|dgcnn] [--eval_only] \
        [--device cuda|cpu] ...

A batch is a dict of tensors in the dataset contract's DCP form (column
convention R): ``points_src_sample`` / ``points_tar_sample`` (B, N, 3),
``points_based_neighs_src`` / ``_tar`` (B, F * 3, 3), ``tar_box`` (B, 8, 3),
``centers`` (B, 3), ``R`` / ``R_inv`` (B, 3, 3), ``T`` / ``T_inv`` (B, 3).
The network runs once per batch; on a CUDA device the resampler and stage 1
each launch one kernel per batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.data import dataset as DS
from a_robust_registration_loss_tpu_torch.data import objio
from a_robust_registration_loss_tpu_torch.eval import metrics as EM
from a_robust_registration_loss_tpu_torch.models.dcp import DCP, DCPConfig, reset_parameters
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.train import harness
from a_robust_registration_loss_tpu_torch.train import losses as L


@dataclasses.dataclass(frozen=True)
class DCPTrainConfig:
    lr: float = 1e-6
    # the supervised pretrain phase that produces, in-repo, the supervised
    # init the reference fine-tunes from: loss_gt, a fresh Adam at
    # pretrain_lr; the main phase then starts with a fresh optimiser
    pretrain_epochs: int = 0
    pretrain_lr: float = 1e-4
    loss: L.LossConfig = L.LossConfig(n_lines=15000)
    model: DCPConfig = DCPConfig()
    fit: harness.FitConfig = harness.FitConfig()


def forward(model: DCP, batch):
    return model(batch["points_src_sample"], batch["points_tar_sample"])


def _pre(model: DCP, batch, u4):
    return model.pre_solve(batch["points_src_sample"], batch["points_tar_sample"])


def _solve(model: DCP, pre):
    return model.solve(pre)


def _lines(cfg: DCPTrainConfig):
    return lambda B: (B * L.dp_scale(cfg.loss), 4, LN.ROUNDS * cfg.loss.n_lines)


def train_split(cfg: DCPTrainConfig) -> harness.Split:
    """``train_step`` cut at the SVD head's solves (``harness.Split``):
    the network to the correlations, the SVDs, then the transforms,
    ``dcp_train_loss`` on the uniforms ``u4`` and the guarded Adam step at
    cfg.lr."""
    def post(model, batch, u4, solved):
        return L.dcp_train_loss(batch, *model.post_solve(solved), cfg.loss, u4)

    def update(grads, opt_state, params, loss):
        return harness.guarded_update(cfg.lr, grads, opt_state, params, loss, cfg.loss.mesh)

    return harness.Split((_pre, post), _solve, _lines(cfg), update)


def train_step(model: DCP, opt_state: harness.AdamState, batch, cfg: DCPTrainConfig,
               u4=None, generator=None):
    """One training step: the forward, ``dcp_train_loss`` (lines from ``u4``
    or drawn from ``generator``), its gradient to every parameter, and the
    guarded Adam step at cfg.lr, in place on the model. Returns (opt_state,
    metrics): the loss's monitors, ``loss`` and ``nonfinite_steps`` (1.0
    where a non-finite loss or gradient left the model and the state as
    they were). Under ``cfg.loss.mesh`` the batch is this rank's dp rows,
    ``u4`` the global batch's, and the update averages over dp."""
    split = train_split(cfg)
    if u4 is None:
        u4 = harness.draw(split, batch, generator)
    return harness.run_split(split, model, batch, u4, opt_state)


def pretrain_split(cfg: DCPTrainConfig) -> harness.Split:
    """``pretrain_step`` as a ``harness.Split``: no lines."""
    def post(model, batch, u4, solved):
        R_ab, t_ab, _, _ = model.post_solve(solved)
        loss = EM.gt_consistency_loss(R_ab, t_ab, batch["R"], batch["T"])
        with torch.no_grad():
            mae, rmse = L.euler_errors(R_ab, batch["R"], cfg.loss)
            return loss, dict(loss_rot_euler_mae=mae, loss_rot_euler_rmse=rmse,
                              loss_translation=EM.translation_mse(t_ab, batch["T"]))

    def update(grads, opt_state, params, loss):
        return harness.guarded_update(cfg.pretrain_lr, grads, opt_state, params, loss,
                                      cfg.loss.mesh)

    return harness.Split((_pre, post), _solve, None, update)


def pretrain_step(model: DCP, opt_state: harness.AdamState, batch, cfg: DCPTrainConfig):
    """One supervised pretraining step: ``gt_consistency_loss`` against the
    batch's ground truth, the guarded Adam step at cfg.pretrain_lr, and the
    Euler and translation monitors of the predictions before the step. No
    lines are drawn. Returns (opt_state, metrics)."""
    return harness.run_split(pretrain_split(cfg), model, batch, None, opt_state)


def init_model(cfg: DCPTrainConfig, seed: int, device=None) -> DCP:
    """``DCP(cfg.model)`` with weights drawn from ``seed`` (on the CPU, so the
    draw is the same on every device), on ``device`` (the GPU unless
    "cpu")."""
    model = DCP(cfg.model)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(_device.resolve(device))


def train(cfg: DCPTrainConfig, train_loader, test_loader=None, init_from=None,
          log=print, device=None, mesh=None):
    """Full training: the model from ``init_from`` (a state dict) or drawn
    from cfg.fit.seed, the pretrain phase (cfg.pretrain_epochs, its own
    Trainer under ``exp_dir/pretrain``), then the main phase with eval,
    checkpoints, metrics and artifacts under cfg.fit.exp_dir; each phase
    resumes from its latest checkpoint. Loaders are iterables of batch dicts
    (tensors or arrays); a ``Loader`` goes to the card once through
    ``maybe_device_cache``. With a ``mesh`` (``parallel/mesh.py``) both
    phases train on this rank's share of each batch. Returns (model,
    opt_state, history) of the main phase."""
    dev = _device.resolve(device)
    train_loader = DS.maybe_device_cache(train_loader, dev)
    if test_loader is not None:
        test_loader = DS.maybe_device_cache(test_loader, dev)
    model = init_model(cfg, cfg.fit.seed, dev)
    if init_from is not None:
        model.load_state_dict(init_from)
    if cfg.pretrain_epochs:
        pre_fit = dataclasses.replace(
            cfg.fit, epochs=cfg.pretrain_epochs,
            exp_dir=os.path.join(cfg.fit.exp_dir, "pretrain"))
        pre_trainer = harness.Trainer(
            lambda m, o, b, g, mesh=None: pretrain_step(m, o, b, harness.with_mesh(cfg, mesh)),
            None, pre_fit, score_key="loss", score_mode="min", device=dev, mesh=mesh,
            train_split=pretrain_split(cfg))
        pre_trainer.fit(model, harness.adam_init(model.parameters()), train_loader,
                        log=lambda m: log(f"[pretrain] {m}"))
    trainer = harness.Trainer(
        lambda m, o, b, g, mesh=None: train_step(m, o, b, harness.with_mesh(cfg, mesh),
                                                 generator=g),
        lambda m, b, g, mesh=None: eval_step(m, b, harness.with_mesh(cfg, mesh), generator=g),
        cfg.fit, score_key="loss", score_mode="min", artifact_fn=artifact_fn, device=dev,
        mesh=mesh, train_split=train_split(cfg), eval_split=eval_split(cfg))
    return trainer.fit(model, harness.adam_init(model.parameters()), train_loader,
                       test_loader, log=log)


def _eval_batch(model, batch, cfg: DCPTrainConfig, u4=None, generator=None, solved=None):
    """One network run (or its ``solve`` tuple, ``solved``) -> (metrics,
    (R_ab, t_ab, R_ba, t_ba), pred, gt): eval_step's battery, and the
    transforms and transformed source clouds that the artifact pass
    writes."""
    R_ab, t_ab, R_ba, t_ba = (forward(model, batch) if solved is None
                              else model.post_solve(solved))
    loss_inter, monitors = L.dcp_cal_loss(batch, R_ab, t_ab, cfg.loss, u4, generator)
    src = batch["points_src_sample"]
    tar = batch["points_tar_sample"]
    pred = L.dcp_transform(src, R_ab, t_ab)
    gt = L.dcp_transform(src, batch["R"], batch["T"])
    pred_ba = L.dcp_transform(tar, R_ba, t_ba)
    gt_ba = L.dcp_transform(tar, batch["R_inv"], batch["T_inv"])
    loss = EM.gt_consistency_loss(R_ab, t_ab, batch["R"], batch["T"])
    out = dict(
        monitors,
        loss_intersection=loss_inter,
        loss_pp_wise=EM.pp_wise_mae(pred, gt),
        mse_ab=((pred - gt) ** 2).mean(),
        mae_ab=(pred - gt).abs().mean(),
        mse_ba=((pred_ba - gt_ba) ** 2).mean(),
        mae_ba=(pred_ba - gt_ba).abs().mean(),
    )
    if cfg.loss.cycle:
        cyc = L.dcp_cycle_loss(R_ab, t_ab, R_ba, t_ba)
        loss = loss + 0.1 * cyc
        out["cycle_loss"] = cyc
    out["loss"] = loss  # the test pass's total: loss_gt (+ 0.1 * cycle)
    return out, (R_ab, t_ab, R_ba, t_ba), pred, gt


def eval_split(cfg: DCPTrainConfig) -> harness.Split:
    """``eval_step`` as a ``harness.Split``."""
    def post(model, batch, u4, solved):
        return _eval_batch(model, batch, cfg, u4, solved=solved)[0]

    return harness.Split((_pre, post), _solve, _lines(cfg))


def eval_step(model: DCP, batch, cfg: DCPTrainConfig, u4=None, generator=None):
    """The per-batch battery of the reference's test pass: loss_gt (+ 0.1 *
    cycle), the pp-wise and chamfer errors, the MSE / MAE of the
    transformed clouds in both directions, the Euler and translation
    errors, and the intersection loss on the held-out pairs. A dict of 0-d
    tensors; ``u4`` / ``generator`` as in ``dcp_cal_loss``."""
    return _eval_batch(model, batch, cfg, u4, generator)[0]


def artifact_fn(model: DCP, batch):
    """(src, pred, tar, gt) clouds of the batch's first pair."""
    R_ab, t_ab, _, _ = forward(model, batch)
    src = batch["points_src_sample"]
    pred = L.dcp_transform(src, R_ab, t_ab)
    gt = L.dcp_transform(src, batch["R"], batch["T"])
    return src[0], pred[0], batch["points_tar_sample"][0], gt[0]


def _euler_stats(R_pred, R_gt, t_pred, t_gt, suffix):
    e_p = EM.mat2euler(torch.cat(R_pred), seq="xyz").numpy()
    e_g = EM.mat2euler(torch.cat(R_gt), seq="xyz").numpy()
    tp, tg = torch.cat(t_pred).numpy(), torch.cat(t_gt).numpy()
    r_mse = float(np.mean((e_p - e_g) ** 2))
    t_mse = float(np.mean((tp - tg) ** 2))
    return {
        f"r_mse_{suffix}": r_mse,
        f"r_rmse_{suffix}": float(np.sqrt(r_mse)),
        f"r_mae_{suffix}": float(np.mean(np.abs(e_p - e_g))),
        f"t_mse_{suffix}": t_mse,
        f"t_rmse_{suffix}": float(np.sqrt(t_mse)),
        f"t_mae_{suffix}": float(np.mean(np.abs(tp - tg))),
    }


def evaluate(cfg: DCPTrainConfig, state_dict, test_loader, out_dir: str,
             log=print, epoch: int = 0, save_objs: bool = True, device=None,
             seed: int = 0):
    """The full test pass with its artifacts: the per-batch battery averaged
    over the batches, the exact whole-set Euler and translation errors over
    the concatenated predictions, per-pair OBJ dumps named
    ``{epoch}_{i}pred_src.obj`` / ``gt.obj`` (the target cloud) / ``src.obj``
    / ``src_gt.obj``, and an ``Eval.json`` summary, which is returned.

    ``state_dict`` holds the weights of ``DCP(cfg.model)``; ``test_loader``
    is any iterable of batch dicts (tensors or arrays, on any device). Runs
    on the GPU unless ``device="cpu"``; the lines of batch k come from a
    generator seeded with ``seed``. Per batch the host reads the stacked
    metrics once, the transforms once and, with ``save_objs``, the clouds."""
    dev = _device.resolve(device)
    with dev:  # built where it runs: no copy of every parameter from the host
        model = DCP(cfg.model)
    model.load_state_dict(state_dict)
    model.eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    os.makedirs(out_dir, exist_ok=True)

    agg, n_batches, count_i = None, 0, 0
    # per batch, on the host: [R_ab, t_ab, R_ba, t_ba] predicted and true
    pred_tf, gt_tf = [], []
    for k, batch in enumerate(test_loader):
        batch = {key: torch.as_tensor(v).to(dev) for key, v in batch.items()}
        with torch.no_grad():
            metrics, tf, pred, gt_src = _eval_batch(model, batch, cfg, generator=gen)
            keys = sorted(metrics)
            values = torch.stack([metrics[key] for key in keys]).cpu().double().numpy()
            B = pred.shape[0]
            gt = [batch[key] for key in ("R", "T", "R_inv", "T_inv")]
            flat = torch.cat([x.reshape(B, -1) for x in (*tf, *gt)], dim=-1).cpu()
        agg = values if agg is None else agg + values
        n_batches += 1
        for dst, f in ((pred_tf, flat[:, :24]), (gt_tf, flat[:, 24:])):
            dst.append([f[:, :9].reshape(B, 3, 3), f[:, 9:12],
                        f[:, 12:21].reshape(B, 3, 3), f[:, 21:24]])
        m = dict(zip(keys, values))
        log(f"i{k}, loss_gt:{m['loss_gt']:4f}, loss_pp_wise{m['loss_pp_wise']:4f}, "
            f"loss_chamfer{m['loss_chamfer']:4f}")
        if save_objs:
            clouds = torch.stack([pred, batch["points_tar_sample"],
                                  batch["points_src_sample"], gt_src]).cpu().numpy()
            for b in range(B):
                pre = os.path.join(out_dir, f"{epoch}_{count_i}")
                for name, cloud in zip(("pred_src", "gt", "src", "src_gt"), clouds):
                    objio.write_obj(f"{pre}{name}.obj", cloud[b])
                count_i += 1
    if not n_batches:
        raise ValueError("evaluate: the test loader gave no batch")

    summary = {key: float(v) / n_batches for key, v in zip(keys, agg)}
    for suffix, (iR, it) in (("ab", (0, 1)), ("ba", (2, 3))):
        summary.update(_euler_stats([p[iR] for p in pred_tf], [g[iR] for g in gt_tf],
                                    [p[it] for p in pred_tf], [g[it] for g in gt_tf],
                                    suffix))
    summary["rmse_ab"] = float(np.sqrt(summary["mse_ab"]))
    summary["rmse_ba"] = float(np.sqrt(summary["mse_ba"]))
    with open(os.path.join(out_dir, "Eval.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log("EVAL " + " ".join(
        f"{key}={summary[key]:.6f}"
        for key in ("loss", "loss_intersection", "loss_chamfer", "rmse_ab",
                    "r_rmse_ab", "r_mae_ab", "t_rmse_ab")))
    return summary


def main(argv=None):
    """The JAX CLI's flags, ``--platform`` and ``--backend`` replaced by
    ``--device``. Returns ``train``'s (model, opt_state, history), or the
    ``Eval.json`` summary with ``--eval_only``. With
    ``--dp`` / ``--sp`` it trains on dp x sp ranks of this host
    (``harness.run_cli``) and returns None where it spawned them."""
    return harness.run_cli(_parser, argv, _run)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--exp_dir", default="./exps/dcp")
    ap.add_argument("--layout", default="indexed", choices=["indexed", "views"])
    ap.add_argument("--n_pairs", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-6)
    ap.add_argument("--pretrain_epochs", type=int, default=0,
                    help="supervised pretrain epochs on the GT loss before the "
                         "unsupervised phase")
    ap.add_argument("--pretrain_lr", type=float, default=1e-4)
    ap.add_argument("--n_lines", type=int, default=15000)
    ap.add_argument("--emb_nn", default="pointnet", choices=["pointnet", "dgcnn"])
    ap.add_argument("--pointer", default="transformer", choices=["transformer", "identity"])
    ap.add_argument("--head", default="svd", choices=["svd", "mlp"])
    ap.add_argument("--emb_dims", type=int, default=512)
    ap.add_argument("--n_blocks", type=int, default=1)
    ap.add_argument("--n_heads", type=int, default=4)
    ap.add_argument("--ff_dims", type=int, default=1024)
    ap.add_argument("--cycle", action="store_true")
    ap.add_argument("--train_count", type=int, default=None,
                    help="train/test split: first N pairs train, rest test")
    ap.add_argument("--eval_only", action="store_true",
                    help="reload the latest checkpoint and run the test pass with its "
                         "artifacts (metric battery, OBJ dumps, Eval.json)")
    ap.add_argument("--init_from_ckpt", default=None,
                    help="initialize params from ANOTHER experiment's checkpoints "
                         "(fresh optimizer); --exp_dir's own checkpoints still take "
                         "precedence when resuming")
    ap.add_argument("--init_from_torch", default=None,
                    help="a reference DCP .pth to start from")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; fails without one) or cpu (the plain path)")
    harness.add_mesh_flags(ap)
    harness.add_precision_and_debug_flags(ap)
    return ap


def _run(args, ap, mesh=None):
    """``main`` after its flags are parsed, on one rank of ``mesh`` if
    given."""
    if args.init_from_ckpt and args.init_from_torch:
        ap.error("--init_from_ckpt and --init_from_torch are exclusive")
    dev = _device.resolve(args.device)

    train_loader, test_loader = DS.generate_datasets(DS.DatasetConfig(
        data_path=args.data_path, layout=args.layout, n=args.n_pairs,
        train_batch=args.batch_size, dcp=True, seed=args.seed,
        train_count=args.train_count), device=dev)
    cfg = DCPTrainConfig(
        lr=args.lr, pretrain_epochs=args.pretrain_epochs, pretrain_lr=args.pretrain_lr,
        loss=L.LossConfig(n_lines=args.n_lines, cycle=args.cycle),
        model=DCPConfig(emb_nn=args.emb_nn, pointer=args.pointer, head=args.head,
                        emb_dims=args.emb_dims, n_blocks=args.n_blocks,
                        n_heads=args.n_heads, ff_dims=args.ff_dims, cycle=args.cycle,
                        dtype=args.dtype),
        fit=harness.FitConfig(epochs=args.epochs, exp_dir=args.exp_dir,
                              seed=args.seed, artifacts_every=10),
    )
    model = init_model(cfg, cfg.fit.seed, dev)
    init_from = None
    if args.init_from_torch:
        from a_robust_registration_loss_tpu_torch.models import transplant

        init_from = transplant.load_torch_state_dict(args.init_from_torch)
        model.load_state_dict(init_from)
    if args.init_from_ckpt:
        from a_robust_registration_loss_tpu_torch.utils import load_params_from

        init_from = load_params_from(
            args.init_from_ckpt,
            {"params": model.state_dict(),
             "opt_state": harness.adam_init(model.parameters()), "epoch": 0})
        if init_from is None:
            ap.error(f"no checkpoint under {args.init_from_ckpt}")
        model.load_state_dict(init_from)
    if args.eval_only:
        from a_robust_registration_loss_tpu_torch.utils import CheckPointManager

        ckpt = CheckPointManager(os.path.join(args.exp_dir, "checkpoints"))
        state, _ = ckpt.load({"params": model.state_dict(),
                              "opt_state": harness.adam_init(model.parameters()),
                              "epoch": 0})
        epoch = 0
        if state is not None:
            model.load_state_dict(state["params"])
            epoch = int(state["epoch"])
        return evaluate(cfg, model.state_dict(), test_loader,
                        os.path.join(args.exp_dir, "eval"), epoch=epoch, device=dev)
    return train(cfg, train_loader, test_loader, init_from=init_from, device=dev,
                 mesh=mesh)


if __name__ == "__main__":
    main()
