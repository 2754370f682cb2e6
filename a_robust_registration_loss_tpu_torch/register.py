#!/usr/bin/env python
"""One-shot registration of two point-cloud files on the GPU.

    python -m a_robust_registration_loss_tpu_torch.register src.obj tar.ply \
        --out transform.txt [--pred_out reg.obj] [--device cuda]

Writes the 3x4 [R | t] text matrix such that, in the MEAN-CENTRED frames,
``src_centered @ R + t ~= tar_centered``; with --uncentered the transform
is re-expressed for the raw input frames. Runs on ``cuda`` unless
``--device cpu`` is given, and raises when no GPU is there.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _read_cloud(path):
    from a_robust_registration_loss_tpu_torch.data import objio, plyio

    if path.lower().endswith(".ply"):
        v, _ = plyio.read_ply(path)
    else:
        v, _ = objio.read_obj(path)
    return np.asarray(v, np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help=".obj or .ply source cloud")
    ap.add_argument("tar", help=".obj or .ply target cloud")
    ap.add_argument("--out", default="transform.txt",
                    help="3x4 [R|t] text output")
    ap.add_argument("--pred_out", default=None,
                    help="optional .obj of the registered (transformed) "
                         "source cloud, in the raw target frame")
    ap.add_argument("--n_epochs", type=int, default=1000)
    ap.add_argument("--n_lines", type=int, default=20000)
    ap.add_argument("--num_sample", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--uncentered", action="store_true",
                    help="express [R|t] in the RAW input frames instead of "
                         "the mean-centred frames")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    from a_robust_registration_loss_tpu_torch.data import objio
    from a_robust_registration_loss_tpu_torch.train import classical

    src = _read_cloud(args.src)
    tar = _read_cloud(args.tar)
    cfg = classical.ClassicalConfig(
        n_epochs=args.n_epochs, n_lines=args.n_lines,
        num_sample=args.num_sample, seed=args.seed,
        log_every=max(args.n_epochs // 5, 1))

    t0 = time.perf_counter()
    params, hist = classical.run(src, tar, cfg, device=args.device)
    dt = time.perf_counter() - t0
    R, t, transform = classical.final_transform(params)

    c_src = src.mean(0)
    c_tar = tar.mean(0)
    if args.uncentered:
        # raw frames: y = (x - c_src) @ R + t + c_tar
        transform = np.ones((3, 4), np.float64)
        transform[:3, :3] = R
        transform[:3, 3] = t - c_src @ R + c_tar
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savetxt(args.out, transform)
    if args.pred_out:
        pred = (src - c_src) @ R + t + c_tar
        objio.write_obj(args.pred_out, pred.astype(np.float32))
    print(f"registered {args.src} -> {args.tar}: final metric "
          f"{float(hist['loss'][-1]):.6f}, chamfer "
          f"{float(hist['chamfer'][-1]):.6f}, {args.n_epochs} epochs in "
          f"{dt:.1f}s -> {args.out}")


if __name__ == "__main__":
    main()
