"""Unsupervised FMR training and evaluation, and its CLI.

Port of ``a_robust_registration_loss_tpu/train/fmr.py``: the
feature-metric registration solver trained with the AE chamfer loss plus
the intersected-line metric on its last 3 IC iterates.

- total = 0.01 * loss_ende + 1.0 * loss_intersection, Adam at lr 1e-6
  through ``harness.guarded_update``;
- train maxiter 5, eval maxiter 10;
- the eval loss is comp_inv = mse(g, inverse(igt)), beside the pp-wise,
  AE, Euler and dm = ||log(g . igt)|| monitors;
- ``evaluate`` writes the twist CSV (``eval_twists.csv``), the dm summary
  (``eval_summary.json``) and, optionally, the clouds of each pair.

A training step launches one resampler kernel and three stage-1 kernels on
the card; an eval step launches none. ``train`` feeds the steps from a
``DeviceCache`` where the dataset allows it.

CLI:
    python -m a_robust_registration_loss_tpu_torch.train.fmr \\
        --data_path DIR --exp_dir EXP [--eval_only] [--device cuda|cpu] ...
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
from a_robust_registration_loss_tpu_torch.eval import metrics as EM
from a_robust_registration_loss_tpu_torch.models.dcp import reset_parameters
from a_robust_registration_loss_tpu_torch.models.fmr import FMRConfig, SolveRegistration
from a_robust_registration_loss_tpu_torch.se3 import se3
from a_robust_registration_loss_tpu_torch.train import harness
from a_robust_registration_loss_tpu_torch.train import losses as L
from a_robust_registration_loss_tpu_torch.utils import debug


@dataclasses.dataclass(frozen=True)
class FMRTrainConfig:
    lr: float = 1e-6
    train_maxiter: int = 5
    eval_maxiter: int = 10
    loss: L.LossConfig = L.LossConfig(n_lines=15000)
    model: FMRConfig = FMRConfig()
    fit: harness.FitConfig = harness.FitConfig()


def forward(model: SolveRegistration, batch, maxiter: int):
    return model(batch["points_tar_sample"], batch["points_src_sample"], maxiter=maxiter)


def _monitors(g, batch, cfg: FMRTrainConfig):
    """comp_inv (the MSE of g against inverse(igt)) and the Euler errors
    of g's rotation against the row-convention R."""
    loss_g = ((g - se3.inverse(batch["igt"])) ** 2).mean()
    mae, rmse = L.euler_errors(g[:, :3, :3].transpose(-1, -2), batch["R"], cfg.loss)
    return loss_g, mae, rmse


def train_step(model: SolveRegistration, opt_state: harness.AdamState, batch,
               cfg: FMRTrainConfig, u4=None, generator=None):
    """One training step: the forward at cfg.train_maxiter, ``fmr_train_loss``
    (lines from ``u4`` or drawn from ``generator``), its gradient to every
    parameter, and the guarded Adam step at cfg.lr, in place on the model.
    Returns (opt_state, metrics): the loss's parts, ``loss``, ``loss_gt``,
    the Euler errors of the forward, ``nonfinite_steps`` and
    ``n_singular``. Under ``cfg.loss.mesh`` the batch is this rank's dp
    rows, ``u4`` the global batch's, the update averages over dp and
    ``n_singular``, a count, is scaled to the global batch."""
    params = list(model.parameters())
    out = forward(model, batch, cfg.train_maxiter)
    total, parts = L.fmr_train_loss(out["g_series"], out["loss_ende"], batch, cfg.loss,
                                    cfg.train_maxiter, u4, generator)
    grads = debug.grad(total, params, allow_unused=True)
    loss = total.detach()
    opt_state, nonfinite = harness.guarded_update(cfg.lr, grads, opt_state, params, loss,
                                                  cfg.loss.mesh)
    with torch.no_grad():
        loss_g, mae, rmse = _monitors(out["g"], batch, cfg)
    return opt_state, dict(parts, loss=loss, loss_gt=loss_g, loss_rot_euler_mae=mae,
                           loss_rot_euler_rmse=rmse, nonfinite_steps=nonfinite,
                           n_singular=out["n_singular"].float() * L.dp_scale(cfg.loss))


def eval_step(model: SolveRegistration, batch, cfg: FMRTrainConfig):
    """The validation battery at cfg.eval_maxiter: ``loss`` = comp_inv,
    pp-wise, AE loss, dm, Euler errors and ``n_singular`` (scaled as in
    ``train_step``). No lines."""
    out = forward(model, batch, cfg.eval_maxiter)
    g = out["g"]
    src = batch["points_src_sample"]
    pred = se3.transform(g[:, None], src)
    gt_src = se3.transform(se3.inverse(batch["igt"])[:, None], src)
    dm, _ = EM.dm_twist_error(g, batch["igt"])
    loss_g, mae, rmse = _monitors(g, batch, cfg)
    return dict(loss=loss_g, loss_pp_wise=(pred - gt_src).abs().mean(),
                loss_ende=out["loss_ende"], dm=dm, loss_rot_euler_mae=mae,
                loss_rot_euler_rmse=rmse,
                n_singular=out["n_singular"].float() * L.dp_scale(cfg.loss))


def artifact_fn(model: SolveRegistration, batch, cfg: FMRTrainConfig):
    """(src, pred, tar, gt) clouds of the batch's first pair, at
    cfg.eval_maxiter."""
    g = forward(model, batch, cfg.eval_maxiter)["g"]
    src = batch["points_src_sample"]
    pred = se3.transform(g[:, None], src)
    gt = se3.transform(se3.inverse(batch["igt"])[:, None], src)
    return src[0], pred[0], batch["points_tar_sample"][0], gt[0]


def init_model(cfg: FMRTrainConfig, seed: int, device=None) -> SolveRegistration:
    """``SolveRegistration(cfg.model)`` with weights drawn from ``seed`` (on
    the CPU, so the draw is the same on every device), on ``device`` (the
    GPU unless "cpu")."""
    model = SolveRegistration(cfg.model)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(_device.resolve(device))


def train(cfg: FMRTrainConfig, train_loader, test_loader=None, init_from=None,
          log=print, device=None, mesh=None):
    """Full training on ``harness.Trainer``: the model from ``init_from`` (a
    state dict) or drawn from cfg.fit.seed, eval, checkpoints, metrics and
    artifacts under cfg.fit.exp_dir, resuming from its latest checkpoint.
    ``Loader``s go to the card once through ``maybe_device_cache``; any
    other iterable of batch dicts is taken as it is. With a ``mesh``
    (``parallel/mesh.py``) it trains on this rank's share of each batch.
    Returns (model, opt_state, history)."""
    dev = _device.resolve(device)
    train_loader = DS.maybe_device_cache(train_loader, dev)
    if test_loader is not None:
        test_loader = DS.maybe_device_cache(test_loader, dev)
    model = init_model(cfg, cfg.fit.seed, dev)
    if init_from is not None:
        model.load_state_dict(init_from)
    trainer = harness.Trainer(
        lambda m, o, b, g, mesh=None: train_step(m, o, b, harness.with_mesh(cfg, mesh),
                                                 generator=g),
        lambda m, b, g, mesh=None: eval_step(m, b, harness.with_mesh(cfg, mesh)), cfg.fit,
        score_key="loss", score_mode="min",
        artifact_fn=lambda m, b: artifact_fn(m, b, cfg), device=dev, mesh=mesh)
    return trainer.fit(model, harness.adam_init(model.parameters()), train_loader,
                       test_loader, log=log)


def ablate_batch(batch, rng, add_noise: bool = False, add_density: bool = False,
                 density_ratio: float = 0.5):
    """The reference's eval ablations on the source cloud: Gaussian 0.01
    noise and / or a random ``density_ratio`` subset, from the numpy
    generator ``rng`` (the JAX package's draws). Returns a batch whose
    source is a numpy array."""
    batch = dict(batch)
    p1 = torch.as_tensor(batch["points_src_sample"]).cpu().numpy()
    if add_noise:
        p1 = rng.normal(p1, 0.01).astype(np.float32)
    if add_density:
        n = p1.shape[1]
        keep = rng.choice(np.arange(1, n), size=int(n * density_ratio), replace=False)
        p1 = p1[:, keep]
    batch["points_src_sample"] = p1
    return batch


def evaluate(cfg: FMRTrainConfig, state_dict, test_loader, out_dir: str, log=print,
             add_noise: bool = False, add_density: bool = False, seed: int = 0,
             save_objs: bool = False, device=None):
    """The reference's FMR test pass: per pair the twist rows
    [log(g), -log(igt)] into ``eval_twists.csv`` (``TWIST_CSV_HEADER``) and
    dm = ||log(g . igt)||, the mean dm into ``eval_summary.json``; the noise
    / density ablations drawn from ``default_rng(seed)``; with
    ``save_objs`` each batch's first pair's clouds and the colored-ply
    set of ``viz.draw_registration_result`` (its PNG where matplotlib
    imports). Runs on the GPU unless ``device="cpu"``. Returns the mean
    dm."""
    from a_robust_registration_loss_tpu_torch.utils import viz

    dev = _device.resolve(device)
    with dev:  # built where it runs: no copy of every parameter from the host
        model = SolveRegistration(cfg.model)
    model.load_state_dict(state_dict)
    model.eval()
    os.makedirs(out_dir, exist_ok=True)
    png = save_objs
    if save_objs:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            png = False
            log(f"registration.png skipped: matplotlib does not import ({e}); the ply "
                "triples are written")
    csv_path = os.path.join(out_dir, "eval_twists.csv")
    dms = []
    np_rng = np.random.default_rng(seed)
    with open(csv_path, "w") as fout:
        print(EM.TWIST_CSV_HEADER, file=fout)
        for i, batch in enumerate(test_loader):
            if add_noise or add_density:
                batch = ablate_batch(batch, np_rng, add_noise, add_density)
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            with torch.no_grad():
                g = forward(model, batch, cfg.eval_maxiter)["g"]
                dm, dn = EM.dm_twist_error(g, batch["igt"])
                rows = EM.twist_csv_rows(g, batch["igt"])
                # one read of the batch's numbers
                host = torch.cat([dm[None], dn, rows.reshape(-1)]).cpu()
            B = g.shape[0]
            dm_b, dn_b, rows_b = host[0], host[1:1 + B], host[1 + B:].reshape(B, -1)
            for r in rows_b.tolist():
                print(",".join(str(float(v)) for v in r), file=fout)
            dms.extend(dn_b.tolist())
            if save_objs:
                src = batch["points_src_sample"]
                pred = se3.transform(g[:, None], src)
                gt = se3.transform(se3.inverse(batch["igt"])[:, None], src)
                clouds = [x[0].cpu().numpy() for x in (src, pred, batch["points_tar_sample"], gt)]
                harness.dump_registration_objs(out_dir, f"pair{i}", *clouds)
                viz.draw_registration_result(clouds[0], clouds[2], g[0].cpu().numpy(),
                                             os.path.join(out_dir, f"pair{i}_viz"), png=png)
            log(f"test, {i}/{len(test_loader)}, dm={float(dm_b):.6f}")
    mean_dm = float(np.mean(dms)) if dms else float("nan")
    with open(os.path.join(out_dir, "eval_summary.json"), "w") as f:
        json.dump({"mean_dm": mean_dm, "n": len(dms)}, f)
    log(f"mean dm: {mean_dm:.6f} over {len(dms)} pairs -> {csv_path}")
    return mean_dm


def load_reference(model, sd, optional: str = "decoder."):
    """Load a reference state dict into ``model``: every key must be one of
    the model's, and every key of the model must be given except those
    under ``optional``, which keep their values. Raises KeyError
    otherwise."""
    res = model.load_state_dict(sd, strict=False)
    missing = [k for k in res.missing_keys if not k.startswith(optional)]
    if res.unexpected_keys or missing:
        raise KeyError(f"reference state dict: unexpected {res.unexpected_keys}, "
                       f"missing {missing}")
    return model


def main(argv=None):
    """The JAX CLI's flags, ``--platform`` and ``--backend`` replaced by
    ``--device``. Returns ``train``'s (model, opt_state, history), or the
    mean dm with ``--eval_only``. With
    ``--dp`` / ``--sp`` it trains on dp x sp ranks of this host
    (``harness.run_cli``) and returns None where it spawned them."""
    return harness.run_cli(_parser, argv, _run)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--exp_dir", default="./exps/fmr")
    ap.add_argument("--layout", default="indexed", choices=["indexed", "views"])
    ap.add_argument("--n_pairs", type=int, default=4)
    ap.add_argument("--train_count", type=int, default=None,
                    help="train/test split: first N pairs train, rest test")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--n_lines", type=int, default=15000)
    ap.add_argument("--lr", type=float, default=1e-6)
    ap.add_argument("--dim_k", type=int, default=1024)
    ap.add_argument("--train_maxiter", type=int, default=5)
    ap.add_argument("--eval_maxiter", type=int, default=10)
    ap.add_argument("--eval_only", action="store_true")
    ap.add_argument("--init_from_ckpt", default=None,
                    help="initialize params from ANOTHER experiment's checkpoints "
                         "(fresh optimizer); --exp_dir's own checkpoints still take "
                         "precedence when resuming")
    ap.add_argument("--init_from_torch", default=None,
                    help="a reference FMR .pth to start from. With --eval_only its "
                         "decoder.* keys are stripped and the decoder keeps its random "
                         "init, as the reference's evaluation loads it")
    ap.add_argument("--add_noise", action="store_true",
                    help="eval ablation: gaussian 0.01 noise on the source")
    ap.add_argument("--add_density", action="store_true",
                    help="eval ablation: random 50%% source subset")
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
        train_batch=args.batch_size, fmr=True, seed=args.seed,
        train_count=args.train_count), device=dev)
    # shapes only; the train split can be empty in eval-only runs
    batch0 = next(iter(train_loader), None)
    if batch0 is None:
        batch0 = next(iter(test_loader))
    cfg = FMRTrainConfig(
        lr=args.lr, train_maxiter=args.train_maxiter, eval_maxiter=args.eval_maxiter,
        loss=L.LossConfig(n_lines=args.n_lines),
        model=FMRConfig(dim_k=args.dim_k, num_points=batch0["points_src_sample"].shape[1],
                        dtype=args.dtype),
        fit=harness.FitConfig(epochs=args.epochs, exp_dir=args.exp_dir,
                              seed=args.seed, artifacts_every=10),
    )
    model = init_model(cfg, cfg.fit.seed, dev)
    if args.eval_only:
        if args.init_from_torch:
            from a_robust_registration_loss_tpu_torch.models import transplant

            sd = transplant.load_torch_state_dict(args.init_from_torch)
            load_reference(model, {k: v for k, v in sd.items()
                                   if not k.startswith("decoder.")})
        else:
            from a_robust_registration_loss_tpu_torch.utils import CheckPointManager

            ckpt = CheckPointManager(os.path.join(args.exp_dir, "checkpoints"))
            state, _ = ckpt.load({"params": model.state_dict(),
                                  "opt_state": harness.adam_init(model.parameters()),
                                  "epoch": 0})
            if state is not None:
                model.load_state_dict(state["params"])
        return evaluate(cfg, model.state_dict(), test_loader,
                        os.path.join(args.exp_dir, "eval"), add_noise=args.add_noise,
                        add_density=args.add_density, seed=args.seed, device=dev)
    init_from = None
    if args.init_from_torch:
        from a_robust_registration_loss_tpu_torch.models import transplant

        sd = transplant.load_torch_state_dict(args.init_from_torch)
        init_from = load_reference(model, sd).state_dict()
    if args.init_from_ckpt:
        from a_robust_registration_loss_tpu_torch.utils import load_params_from

        init_from = load_params_from(
            args.init_from_ckpt,
            {"params": model.state_dict(),
             "opt_state": harness.adam_init(model.parameters()), "epoch": 0})
        if init_from is None:
            ap.error(f"no checkpoint under {args.init_from_ckpt}")
    return train(cfg, train_loader, test_loader, init_from=init_from, device=dev,
                 mesh=mesh)


if __name__ == "__main__":
    main()
