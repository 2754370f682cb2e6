"""Unsupervised RPM-Net training and evaluation, and its CLI.

Port of ``a_robust_registration_loss_tpu/train/rpmnet.py``: RPM-Net trained
with the per-iteration discounted intersection loss plus the outlier
regularisation, no ground-truth correspondences.

- total = 10 * loss_reg + 1.0 * loss_intersection (``train/losses.py:
  rpm_total_loss``); 2 registration iterations in training, 5 in
  evaluation; 10,000 lines at the full bounding-box diagonal;
- the learning rate is optax's cosine one-cycle schedule written out
  (``cosine_onecycle_schedule``) with the reference's factors, div_factor
  = final_div_factor = 1: initial = peak = final = ``max_lr``, a constant
  2e-5;
- identity pretraining (``pretrain_step``: 1 iteration, mse(R, I) +
  mse(t, 0) at ``pretrain_lr`` 2e-3) through its own ``Trainer`` under
  ``exp_dir/pretrain``; by default its Adam moments and Adam's count carry
  into training while the schedule's count restarts at 0
  (``reset_schedule_count``: a ``ScheduledAdamState`` keeps the two counts
  apart), or a fresh state with ``pretrain_carry_moments=False``;
- ``evaluate`` writes each pair's OBJ dumps, its 3x4 transform with R
  stored transposed as ``{epoch}_pred_src_{idx}.bin``, and ``Val.json`` with
  the SUMS over pairs of ``loss_gt`` and ``loss_chamfer``.

A batch is a dict of tensors in the dataset's plain contract: row-convention
``R`` (tar = src R + T), which is transposed wherever it meets a predicted
column-convention transform. On the card a training step launches one
batched resampler kernel, one stage-1 kernel an iteration and one gather
kernel a feature pass (4 at 2 iterations); an evaluation step launches one
gather kernel a feature pass (10 at 5 iterations) and a pretraining step 2.
``train`` feeds the steps from a ``DeviceCache`` where the dataset allows
it.

CLI:
    python -m a_robust_registration_loss_tpu_torch.train.rpmnet \\
        --data_path DIR --exp_dir EXP [--pretrain_epochs N] [--eval_only] \\
        [--device cuda|cpu] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.data import dataset as DS
from a_robust_registration_loss_tpu_torch.models.dcp import reset_parameters
from a_robust_registration_loss_tpu_torch.models.rpmnet import RPMNetConfig, RPMNetEarlyFusion
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops.adam import ScheduledAdamState
from a_robust_registration_loss_tpu_torch.se3 import se3
from a_robust_registration_loss_tpu_torch.train import harness
from a_robust_registration_loss_tpu_torch.train import losses as L


@dataclasses.dataclass(frozen=True)
class RPMTrainConfig:
    max_lr: float = 2e-5                   # the OneCycle plateau
    onecycle_epochs: int = 100000
    pct_start: float = 0.001
    num_train_reg_iter: int = 2
    num_eval_reg_iter: int = 5
    pretrain_epochs: int = 0
    # identity pretraining runs at the raw Adam lr, 100 times the schedule's
    pretrain_lr: float = 2e-3
    # carry the Adam moments (and Adam's count) from pretraining into
    # training, as the reference's single Adam does; False = fresh state
    pretrain_carry_moments: bool = True
    loss: L.LossConfig = L.LossConfig(n_lines=10000, wt_inliers=1e-2)
    model: RPMNetConfig = RPMNetConfig()
    fit: harness.FitConfig = harness.FitConfig()


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule written out: count (a 0-d int tensor)
    -> the learning rate, a 0-d float32 tensor on count's device, rounded as
    optax's float32 arithmetic rounds it. From peak / div_factor it rises to
    peak over the first pct_start of transition_steps, falls by cosine to
    peak / (div_factor * final_div_factor) at transition_steps and stays
    there."""
    if transition_steps <= 0:
        raise ValueError("a cosine one-cycle schedule needs transition_steps > 0")
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(count):
        lr = (count >= bounds[-1]).float() * float(values[-1])
        for i in range(len(bounds) - 1):
            start, end = float(values[i]), float(values[i + 1])
            pct = (count - bounds[i]).float() / (bounds[i + 1] - bounds[i])
            interp = end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1)
            lr = lr + ((bounds[i] <= count) & (count < bounds[i + 1])) * interp
        return lr

    return schedule


def lr_schedule(cfg: RPMTrainConfig):
    """The reference's OneCycleLR(max_lr, div_factor=1, final_div_factor=1,
    pct_start): the one-cycle formula, whose value is the constant max_lr
    under those factors."""
    return cosine_onecycle_schedule(cfg.onecycle_epochs, cfg.max_lr, cfg.pct_start, 1.0, 1.0)


def reset_schedule_count(opt_state: ScheduledAdamState) -> ScheduledAdamState:
    """The schedule's count set to 0; the moments and Adam's count kept (the
    handover from pretraining to training)."""
    return ScheduledAdamState(opt_state.adam, torch.zeros_like(opt_state.count))


def forward(model: RPMNetEarlyFusion, batch, num_iter: int):
    return model(batch["points_src_sample"], batch["normals_src"],
                 batch["points_tar_sample"], batch["normals_tar"], num_iter=num_iter)


def _gt_column(batch):
    """The row-convention ground truth as a column transform [R^T | T]."""
    return torch.cat([batch["R"].transpose(-1, -2), batch["T"][..., None]], dim=-1)


def _clouds(batch):
    return (batch["points_src_sample"], batch["normals_src"], batch["points_tar_sample"],
            batch["normals_tar"])


def _split(num_iter: int, last, lines=None, update=None) -> harness.Split:
    """The forward at ``num_iter`` iterations cut at its Kabsch SVDs, then
    ``last(model, batch, u4, (transforms, endpoints))``."""
    def first(model, batch, u4):
        return model.pre_solve(*_clouds(batch))

    def step(model, batch, u4, solved):
        return model.step(*_clouds(batch), solved)

    def final(model, batch, u4, solved):
        return last(model, batch, u4, model.post_solve(solved))

    return harness.Split((first, *[step] * (num_iter - 1), final),
                         lambda model, state: model.solve(state), lines, update)


def train_split(cfg: RPMTrainConfig) -> harness.Split:
    """``train_step`` as a ``harness.Split``: cfg.num_train_reg_iter
    pieces, ``rpm_cal_loss`` on the uniforms ``u4``, the scheduled update."""
    def loss(model, batch, u4, out):
        transforms, endpoints = out
        losses, _ = L.rpm_cal_loss(transforms, endpoints["perm_matrices"], batch, cfg.loss, u4)
        return L.rpm_total_loss(losses), {k: v.detach() for k, v in losses.items()}

    def update(grads, opt_state, params, loss):
        return harness.scheduled_update(lr_schedule(cfg), grads, opt_state, params, loss,
                                        cfg.loss.mesh)

    return _split(cfg.num_train_reg_iter, loss,
                  lambda B: (B * L.dp_scale(cfg.loss), 4, LN.ROUNDS * cfg.loss.n_lines), update)


def train_step(model: RPMNetEarlyFusion, opt_state: ScheduledAdamState, batch,
               cfg: RPMTrainConfig, u4=None, generator=None):
    """One training step: the forward at cfg.num_train_reg_iter,
    ``rpm_cal_loss`` (lines from ``u4`` or drawn from ``generator``), the
    gradient of ``rpm_total_loss`` to every parameter, and the guarded Adam
    step at ``lr_schedule(cfg)`` of the schedule's count, in place on the
    model. Returns (opt_state, metrics): the losses, ``loss`` and
    ``nonfinite_steps``. Under ``cfg.loss.mesh`` the batch is this rank's
    dp rows, ``u4`` the global batch's, and the update averages over dp."""
    split = train_split(cfg)
    if u4 is None:
        u4 = harness.draw(split, batch, generator)
    return harness.run_split(split, model, batch, u4, opt_state)


def _eval(batch, transforms, cfg: RPMTrainConfig):
    src = batch["points_src_sample"][..., :3]
    pred_src = se3.rt_transform(transforms[-1], src)
    gt_src = se3.rt_transform(_gt_column(batch), src)
    mae, rmse = L.euler_errors(transforms[-1][..., :3, :3], batch["R"].transpose(-1, -2),
                               cfg.loss)
    return dict(loss=(gt_src - pred_src).abs().mean(),
                loss_chamfer=G.chamfer_distance(batch["points_tar_sample"], pred_src.detach()),
                loss_rot_euler_mae=mae, loss_rot_euler_rmse=rmse)


def eval_split(cfg: RPMTrainConfig) -> harness.Split:
    """``eval_step`` as a ``harness.Split``: no lines."""
    return _split(cfg.num_eval_reg_iter, lambda model, batch, u4, out: _eval(batch, out[0], cfg))


def eval_step(model: RPMNetEarlyFusion, batch, cfg: RPMTrainConfig):
    """The ground-truth monitors of the last of cfg.num_eval_reg_iter
    iterations: ``loss`` = mean |gt - pred| of the moved source, its chamfer
    distance to the target and the Euler errors. No lines."""
    transforms, _ = forward(model, batch, cfg.num_eval_reg_iter)
    return _eval(batch, transforms, cfg)


def pretrain_split(cfg: RPMTrainConfig) -> harness.Split:
    """``pretrain_step`` as a ``harness.Split``: one iteration, no lines."""
    def loss(model, batch, u4, out):
        R = out[0][0][..., :3, :3]
        t = out[0][0][..., :3, 3]
        eye = torch.eye(3, dtype=R.dtype, device=R.device)
        return ((R - eye) ** 2).mean() + (t**2).mean(), {}

    def update(grads, opt_state, params, loss):
        return harness.scheduled_update(lambda _: cfg.pretrain_lr, grads, opt_state, params,
                                        loss, cfg.loss.mesh)

    return _split(1, loss, None, update)


def pretrain_step(model: RPMNetEarlyFusion, opt_state: ScheduledAdamState, batch,
                  cfg: RPMTrainConfig):
    """One identity-pretraining step: 1 iteration, loss = mse(R, I) +
    mse(t, 0), the guarded Adam step at cfg.pretrain_lr (the schedule's
    count advances too). No lines. Returns (opt_state, metrics)."""
    return harness.run_split(pretrain_split(cfg), model, batch, None, opt_state)


def artifact_fn(model: RPMNetEarlyFusion, batch, cfg: RPMTrainConfig):
    """(src, pred, tar, gt) clouds of the batch's first pair, at
    cfg.num_eval_reg_iter."""
    transforms, _ = forward(model, batch, cfg.num_eval_reg_iter)
    src = batch["points_src_sample"][..., :3]
    pred = se3.rt_transform(transforms[-1], src)
    gt = se3.rt_transform(_gt_column(batch), src)
    return src[0], pred[0], batch["points_tar_sample"][0], gt[0]


def init_model(cfg: RPMTrainConfig, seed: int, device=None) -> RPMNetEarlyFusion:
    """``RPMNetEarlyFusion(cfg.model)`` with weights drawn from ``seed`` (on
    the CPU, so the draw is the same on every device), on ``device`` (the
    GPU unless "cpu")."""
    model = RPMNetEarlyFusion(cfg.model)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(_device.resolve(device))


def train(cfg: RPMTrainConfig, train_loader, test_loader=None, init_from=None, log=print,
          device=None, mesh=None):
    """Full training: the model from ``init_from`` (a state dict) or drawn
    from cfg.fit.seed; identity pretraining for cfg.pretrain_epochs (its own
    Trainer under ``exp_dir/pretrain``, no checkpoints, run again on a
    resume: the main phase's checkpoint then replaces its result); then the
    main phase with eval, checkpoints, metrics and artifacts under
    cfg.fit.exp_dir, resuming from its latest checkpoint. ``Loader``s go to
    the card once through ``maybe_device_cache``. With a ``mesh``
    (``parallel/mesh.py``) both phases train on this rank's share of each
    batch. Returns (model, opt_state, history) of the main phase."""
    dev = _device.resolve(device)
    train_loader = DS.maybe_device_cache(train_loader, dev)
    if test_loader is not None:
        test_loader = DS.maybe_device_cache(test_loader, dev)
    model = init_model(cfg, cfg.fit.seed, dev)
    if init_from is not None:
        model.load_state_dict(init_from)
    opt_state = harness.scheduled_adam_init(model.parameters())
    if cfg.pretrain_epochs:
        log_every = max(1, cfg.pretrain_epochs // 50)
        pre_fit = dataclasses.replace(
            cfg.fit, epochs=cfg.pretrain_epochs, save_every=0, artifacts_every=0,
            resume=False, exp_dir=os.path.join(cfg.fit.exp_dir, "pretrain"))
        pre_trainer = harness.Trainer(
            lambda m, o, b, g, mesh=None: pretrain_step(m, o, b, harness.with_mesh(cfg, mesh)),
            None, pre_fit, score_key="loss", device=dev, mesh=mesh,
            train_split=pretrain_split(cfg))
        seen = [0]

        def pre_log(msg):
            if seen[0] % log_every == 0 or seen[0] == cfg.pretrain_epochs - 1:
                log(f"pretrain {msg}")
            seen[0] += 1

        _, opt_state, _ = pre_trainer.fit(model, opt_state, train_loader, log=pre_log)
        opt_state = (reset_schedule_count(opt_state) if cfg.pretrain_carry_moments
                     else harness.scheduled_adam_init(model.parameters()))
    trainer = harness.Trainer(
        lambda m, o, b, g, mesh=None: train_step(m, o, b, harness.with_mesh(cfg, mesh),
                                                 generator=g),
        lambda m, b, g, mesh=None: eval_step(m, b, harness.with_mesh(cfg, mesh)), cfg.fit,
        score_key="loss",
        score_mode="min", artifact_fn=lambda m, b: artifact_fn(m, b, cfg), device=dev,
        mesh=mesh, train_split=train_split(cfg), eval_split=eval_split(cfg))
    return trainer.fit(model, opt_state, train_loader, test_loader, log=log)


def evaluate(cfg: RPMTrainConfig, state_dict, test_loader, out_dir: str, log=print,
             epoch: int = 0, device=None):
    """The evaluation pass with its artifacts, per pair (batches of any size
    are unrolled per sample): ``pair{idx}_{src,pred_src,tar,gt_src}.obj``,
    the last iteration's 3x4 transform as raw float32
    ``{epoch}_pred_src_{idx}.bin`` with R stored TRANSPOSED, and
    ``Val.json`` with the sums over pairs of ``loss_gt`` (mean |gt - pred|
    of the moved source) and ``loss_chamfer``, which is returned. Runs on
    the GPU unless ``device="cpu"``; the host reads each batch's numbers in
    one copy."""
    from a_robust_registration_loss_tpu_torch.utils.logging import dict_to_file

    dev = _device.resolve(device)
    with dev:  # built where it runs: no copy of every parameter from the host
        model = RPMNetEarlyFusion(cfg.model)
    model.load_state_dict(state_dict)
    model.eval()
    os.makedirs(out_dir, exist_ok=True)
    sum_gt, sum_cd, idx = 0.0, 0.0, 0
    for batch in test_loader:
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():
            transforms, _ = forward(model, batch, cfg.num_eval_reg_iter)
            src = batch["points_src_sample"][..., :3]
            tar = batch["points_tar_sample"]
            pred = se3.rt_transform(transforms[-1], src)
            gt = se3.rt_transform(_gt_column(batch), src)
            loss_gt = (gt - pred).abs().mean(dim=(1, 2))
            loss_cd = G.chamfer_distance(tar, pred, per_sample=True)
            B = src.shape[0]
            parts = (transforms[-1], loss_gt, loss_cd, src, pred, tar, gt)
            host = torch.cat([x.reshape(B, -1) for x in parts], dim=1).cpu().numpy()
        sizes = np.cumsum([x[0].numel() for x in parts])[:-1]
        for b in range(B):
            t34, lgt, lcd, *clouds = np.split(host[b], sizes)
            sum_gt += float(lgt[0])
            sum_cd += float(lcd[0])
            harness.dump_registration_objs(out_dir, f"pair{idx}",
                                           *(c.reshape(-1, 3) for c in clouds))
            t34 = t34.reshape(3, 4)
            np.concatenate([t34[:, :3].T, t34[:, 3:]], axis=1).astype(np.float32).tofile(
                os.path.join(out_dir, f"{epoch}_pred_src_{idx}.bin"))
            log(f"eval pair {idx}: loss_gt={float(lgt[0]):.6f} "
                f"loss_chamfer={float(lcd[0]):.6f}")
            idx += 1
    summary = {"loss_chamfer": sum_cd, "loss_gt": sum_gt}
    dict_to_file(os.path.join(out_dir, "Val.json"), summary, file_type="json")
    log(f"Validate, loss_gt {sum_gt:.4f}, loss_chamfer {sum_cd:.4f}")
    return summary


def main(argv=None):
    """The JAX CLI's flags, ``--platform`` and ``--backend`` replaced by
    ``--device``. Returns ``train``'s (model, opt_state, history), or the
    ``Val.json`` summary with ``--eval_only``. With
    ``--dp`` / ``--sp`` it trains on dp x sp ranks of this host
    (``harness.run_cli``) and returns None where it spawned them."""
    return harness.run_cli(_parser, argv, _run)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--exp_dir", default="./exps/rpm")
    ap.add_argument("--layout", default="indexed", choices=["indexed", "views"])
    ap.add_argument("--n_pairs", type=int, default=4)
    ap.add_argument("--train_count", type=int, default=None,
                    help="train/test split: first N pairs train, rest test")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--n_lines", type=int, default=10000)
    ap.add_argument("--wt_inliers", type=float, default=1e-2)
    ap.add_argument("--radius", type=float, default=0.3, help="feature neighbourhood radius")
    ap.add_argument("--num_neighbors", type=int, default=64)
    ap.add_argument("--feat_dim", type=int, default=96)
    ap.add_argument("--num_sk_iter", type=int, default=5,
                    help="sinkhorn normalisation iterations")
    ap.add_argument("--features", default="ppf,dxyz,xyz",
                    help="comma-separated feature set")
    ap.add_argument("--no_slack", action="store_true",
                    help="disable the sinkhorn slack row/column")
    ap.add_argument("--anneal", default="net", choices=["net", "constant"],
                    help="annealing parameters from the PointNet predictor (default) or "
                         "the learnable-constant ablation")
    ap.add_argument("--max_lr", type=float, default=2e-5, help="the OneCycle plateau lr")
    ap.add_argument("--train_reg_iter", type=int, default=2)
    ap.add_argument("--eval_reg_iter", type=int, default=5)
    ap.add_argument("--pretrain_epochs", type=int, default=0)
    ap.add_argument("--pretrain_lr", type=float, default=2e-3,
                    help="identity-pretrain Adam lr")
    ap.add_argument("--init_from_ckpt", default=None,
                    help="initialize params from ANOTHER experiment's checkpoints (fresh "
                         "optimizer); --exp_dir's own checkpoints still take precedence when "
                         "resuming")
    ap.add_argument("--init_from_torch", default=None,
                    help="a reference RPMNetEarlyFusion .pth to start from; works with "
                         "--eval_only too")
    ap.add_argument("--eval_only", action="store_true",
                    help="reload the latest checkpoint and run the eval pass with its "
                         "artifacts (OBJ dumps, transform .bin, Val.json)")
    ap.add_argument("--estimate_normals", action="store_true",
                    help="PCA-estimate missing normals (bare point clouds)")
    ap.add_argument("--num_points", type=int, default=None,
                    help="random subsample both clouds to N points")
    ap.add_argument("--noise_type", default="clean", choices=["clean", "jitter", "crop"],
                    help="clean | jitter (clipped gaussian on the source) | crop (planar "
                         "partial view of the source)")
    ap.add_argument("--rot_mag", type=float, default=0.0,
                    help="extra random source rotation, degrees (0 = off)")
    ap.add_argument("--trans_mag", type=float, default=0.0,
                    help="extra random source translation magnitude")
    ap.add_argument("--partial", type=float, default=None,
                    help="crop keep-ratio (requires --noise_type crop; crop default 0.7)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; fails without one) or cpu (the plain path)")
    harness.add_mesh_flags(ap)
    harness.add_precision_and_debug_flags(ap)
    return ap


def _run(args, ap, mesh=None):
    """``main`` after its flags are parsed, on one rank of ``mesh`` if
    given."""
    if args.partial is not None and args.noise_type != "crop":
        ap.error("--partial only applies with --noise_type crop")
    if args.init_from_ckpt and args.init_from_torch:
        ap.error("--init_from_ckpt and --init_from_torch are exclusive")
    dev = _device.resolve(args.device)

    corrupt = None
    if args.num_points or args.noise_type != "clean" or args.rot_mag > 0 or args.trans_mag > 0:
        corrupt = DS.CorruptConfig(
            num_points=args.num_points, noise_type=args.noise_type, rot_mag=args.rot_mag,
            trans_mag=args.trans_mag,
            partial_keep=0.7 if args.partial is None else args.partial, seed=args.seed)
    train_loader, test_loader = DS.generate_datasets(DS.DatasetConfig(
        data_path=args.data_path, layout=args.layout, n=args.n_pairs,
        train_batch=args.batch_size, seed=args.seed, estimate_normals=args.estimate_normals,
        train_count=args.train_count, corrupt=corrupt), device=dev)
    cfg = RPMTrainConfig(
        max_lr=args.max_lr, num_train_reg_iter=args.train_reg_iter,
        num_eval_reg_iter=args.eval_reg_iter, pretrain_epochs=args.pretrain_epochs,
        pretrain_lr=args.pretrain_lr,
        loss=L.LossConfig(n_lines=args.n_lines, wt_inliers=args.wt_inliers),
        model=RPMNetConfig(features=tuple(args.features.split(",")), feat_dim=args.feat_dim,
                           radius=args.radius, num_neighbors=args.num_neighbors,
                           num_sk_iter=args.num_sk_iter, add_slack=not args.no_slack,
                           anneal=args.anneal, dtype=args.dtype),
        fit=harness.FitConfig(epochs=args.epochs, exp_dir=args.exp_dir, seed=args.seed,
                              artifacts_every=10),
    )
    model = init_model(cfg, cfg.fit.seed, dev)
    template = {"params": model.state_dict(),
                "opt_state": harness.scheduled_adam_init(model.parameters()), "epoch": 0}
    init_from = None
    if args.init_from_torch:
        from a_robust_registration_loss_tpu_torch.models import transplant

        model.load_state_dict(transplant.rpmnet_from_state_dict(
            transplant.load_torch_state_dict(args.init_from_torch)))
        init_from = model.state_dict()
    if args.eval_only:
        epoch = 0
        if init_from is None:
            from a_robust_registration_loss_tpu_torch.utils import CheckPointManager

            state, _ = CheckPointManager(os.path.join(args.exp_dir, "checkpoints")).load(template)
            if state is not None:
                model.load_state_dict(state["params"])
                epoch = int(state["epoch"])
        return evaluate(cfg, model.state_dict(), test_loader,
                        os.path.join(args.exp_dir, "eval"), epoch=epoch, device=dev)
    if args.init_from_ckpt:
        from a_robust_registration_loss_tpu_torch.utils import load_params_from

        init_from = load_params_from(args.init_from_ckpt, template)
        if init_from is None:
            ap.error(f"no checkpoint under {args.init_from_ckpt}")
    return train(cfg, train_loader, test_loader, init_from=init_from, device=dev,
                 mesh=mesh)


if __name__ == "__main__":
    main()
