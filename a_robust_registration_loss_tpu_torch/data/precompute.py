"""Offline neighbour precompute.

Port of ``a_robust_registration_loss_tpu/data/precompute.py``. For every
``*_sample.obj`` cloud it computes the FPS + 3-NN neighbourhood buffer
with ``ops.geometry.sample_neighs`` on the card (``--device cpu`` for the
plain path) and writes:

- ``{stem}_neigh.bin``: float32 (num_sample * num_neigh, 3), the buffer the
  dataset contract reads;
- optionally ``{stem}_neigh.obj``.

Usage:
    python -m a_robust_registration_loss_tpu_torch.data.precompute \\
        --data_path DIR [--num_sample 5000] [--num_neigh 3] [--write_obj] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.data import objio
from a_robust_registration_loss_tpu_torch.ops import geometry as G


def precompute_neighbors(obj_path: str, num_sample: int = 5000,
                         num_neigh: int = 3, write_obj: bool = False,
                         device=None) -> str:
    """Write ``obj_path``'s neighbour buffer (and optionally its OBJ);
    returns the buffer's path. Runs on ``device``, the card unless "cpu"."""
    dev = _device.resolve(device)
    v, _ = objio.read_obj(obj_path)
    neighs = G.sample_neighs(torch.as_tensor(v).to(dev), min(num_sample, v.shape[0]),
                             num_neigh).cpu().numpy().astype(np.float32)
    out_bin = obj_path.replace(".obj", "_neigh.bin")
    neighs.tofile(out_bin)
    if write_obj:
        objio.write_obj(obj_path.replace(".obj", "_neigh.obj"), neighs)
    return out_bin


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--pattern", default="*_sample.obj",
                    help="glob for sample clouds (excludes *_normals.obj)")
    ap.add_argument("--num_sample", type=int, default=5000)
    ap.add_argument("--num_neigh", type=int, default=3)
    ap.add_argument("--write_obj", action="store_true")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; fails without one) or cpu (the plain path)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    paths = sorted(glob.glob(os.path.join(args.data_path, args.pattern)))
    paths = [p for p in paths if "normals" not in os.path.basename(p)
             and "_neigh" not in os.path.basename(p)]
    if not paths:
        raise SystemExit(f"no clouds matching {args.pattern} in {args.data_path}")
    for p in paths:
        out = p.replace(".obj", "_neigh.bin")
        if os.path.exists(out) and not args.overwrite:
            print(f"skip (exists): {out}")
            continue
        out = precompute_neighbors(p, args.num_sample, args.num_neigh,
                                   args.write_obj, dev)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
