"""DCP's evaluation path: the per-batch metric battery and the whole-set
artifact pass.

Port of the serving half of ``a_robust_registration_loss_tpu/train/dcp.py``:
``DCPTrainConfig`` (its model and loss), ``forward``, ``eval_step``,
``artifact_fn`` and ``evaluate``. The training half (the train and pretrain
steps, the trainer runtime with its checkpoints and logs, the CLI) is not
ported yet.

A batch is a dict of tensors in the dataset contract's DCP form (column
convention R): ``points_src_sample`` / ``points_tar_sample`` (B, N, 3),
``points_based_neighs_src`` / ``_tar`` (B, F * 3, 3), ``tar_box`` (B, 8, 3),
``centers`` (B, 3), ``R`` / ``R_inv`` (B, 3, 3), ``T`` / ``T_inv`` (B, 3).
The network runs once per batch; on a CUDA device the resampler and stage 1
each launch one kernel per batch.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.data import objio
from a_robust_registration_loss_tpu_torch.eval import metrics as EM
from a_robust_registration_loss_tpu_torch.models.dcp import DCP, DCPConfig
from a_robust_registration_loss_tpu_torch.train import losses as L


@dataclasses.dataclass(frozen=True)
class DCPTrainConfig:
    loss: L.LossConfig = L.LossConfig(n_lines=15000)
    model: DCPConfig = DCPConfig()


def forward(model: DCP, batch):
    return model(batch["points_src_sample"], batch["points_tar_sample"])


def _eval_batch(model, batch, cfg: DCPTrainConfig, u4=None, generator=None):
    """One network run -> (metrics, (R_ab, t_ab, R_ba, t_ba), pred, gt):
    eval_step's battery, and the transforms and transformed source clouds
    that the artifact pass writes."""
    R_ab, t_ab, R_ba, t_ba = forward(model, batch)
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
