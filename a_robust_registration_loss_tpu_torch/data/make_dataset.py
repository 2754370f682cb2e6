"""Dataset builder: reference-scale registration training sets from base
clouds.

Port of ``a_robust_registration_loss_tpu/data/make_dataset.py``: base
cloud or mesh -> per-view FPS subsets -> optional corruption (jitter /
planar crop) -> a random SE(3) view transform -> normals -> FPS + kNN
neighbour buffers -> the artifact set ``data/dataset.py:load_pair`` reads:
clouds, ``_sample_normals`` companions, ``_neigh.bin`` and float64
``transform*.bin``. The numpy streams are the JAX package's
(``default_rng((seed, mesh, view))``, the same calls in the same order), so
one seed writes the same points, buffers and transforms on both sides;
normals, FPS and neighbours run on ``device``, the card unless "cpu".

GT convention (as ``load_pair`` reads it): ``transform_{m}_{v}.bin`` is a
float64 (3, 4) ``[R | T]`` with ``tar ~= src @ R + T`` in the written,
uncentred frames.

Usage:
    python -m a_robust_registration_loss_tpu_torch.data.make_dataset \\
        --sources 'DIR/*_src_sample.obj' --out ./datasets/views \\
        --n_views 10 --num_points 2048 --rot_mag 45 --trans_mag 0.5 \\
        [--noise_type jitter|crop] [--indexed] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.data import objio, transforms as T
from a_robust_registration_loss_tpu_torch.ops import geometry as G


def _base_normals(v, f, device=None):
    """Mesh faces -> area-weighted vertex normals; a bare cloud -> PCA
    estimates (the reference takes normals from meshes only)."""
    dev = _device.resolve(device)
    pts = torch.as_tensor(v).to(dev)
    if f is not None and len(f) > 0:
        return G.vertex_normals(pts, torch.as_tensor(f).to(dev)).cpu().numpy()
    return G.estimate_normals(pts).cpu().numpy()


def make_view(v_base, n_base, rng, num_points: int, rot_mag_deg: float,
              trans_mag: float, noise_type: str = "clean",
              jitter_scale: float = 0.01, keep_ratio: float = 0.7, device=None):
    """One (src, tar) view pair from a base cloud. Returns a dict of
    float32 / float64 arrays: src / tar points and normals and the (3, 4)
    ground truth."""
    dev = _device.resolve(device)
    n = min(num_points, v_base.shape[0])
    base = torch.as_tensor(v_base).to(dev)[None]

    def subset(start):
        idx = G.farthest_point_sample(
            base, n, start_idx=torch.full((1,), start, dtype=torch.long, device=dev)
        )[0].cpu().numpy()
        return v_base[idx].astype(np.float32), n_base[idx].astype(np.float32)

    tar, tar_n = subset(int(rng.integers(v_base.shape[0])))
    src0, src0_n = subset(int(rng.integers(v_base.shape[0])))

    if noise_type == "jitter":
        src0, _ = T.random_jitter(src0, rng, scale=jitter_scale)
    elif noise_type == "crop":
        src0, idx, _ = T.random_crop(src0, rng, keep_ratio=keep_ratio)
        src0_n = src0_n[idx]

    # random view transform on the source: src = src0 @ Rg + Tg (row)
    _, Rg = T.random_rotator(np.zeros((1, 3), np.float32), rng,
                             mag=np.deg2rad(rot_mag_deg))
    Tg = rng.standard_normal(3)
    Tg = Tg / np.linalg.norm(Tg) * rng.random() * trans_mag
    src = (src0.astype(np.float64) @ Rg + Tg).astype(np.float32)
    src_n = (src0_n.astype(np.float64) @ Rg).astype(np.float32)

    # GT mapping src -> tar's frame: tar ~= src @ R + T
    R = Rg.T
    Tt = -Tg @ Rg.T
    gt = np.concatenate([R, Tt[:, None]], axis=1).astype(np.float64)
    return dict(src=src, src_n=src_n, tar=tar, tar_n=tar_n, gt=gt)


def write_view(out_dir: str, stem_src: str, stem_tar: str, stem_tf: str,
               view: dict, num_sample: int, num_neigh: int, device=None):
    """Write the artifact set of one pair (clouds, normals companions,
    neighbour bins, transform.bin) under the dataset contract's names."""
    dev = _device.resolve(device)

    def neighs(pts):
        return G.sample_neighs(torch.as_tensor(pts).to(dev), min(num_sample, pts.shape[0]),
                               num_neigh).cpu().numpy().astype(np.float32)

    paths = {}
    for tag, pts, nrm in (("src", view["src"], view["src_n"]),
                          ("tar", view["tar"], view["tar_n"])):
        stem = stem_src if tag == "src" else stem_tar
        p = os.path.join(out_dir, stem + ".obj")
        objio.write_obj(p, pts)
        objio.write_obj(
            os.path.join(out_dir, stem.replace("sample", "sample_normals", 1) + ".obj"),
            nrm)
        neighs(pts).tofile(os.path.join(out_dir, stem + "_neigh.bin"))
        paths[tag] = p
    view["gt"].tofile(os.path.join(out_dir, stem_tf + ".bin"))
    return paths


def build(sources, out_dir: str, n_views: int, num_points: int,
          rot_mag: float, trans_mag: float, noise_type: str = "clean",
          jitter_scale: float = 0.01, keep_ratio: float = 0.7,
          num_sample: int = 5000, num_neigh: int = 3, seed: int = 0,
          indexed: bool = False, log=print, device=None):
    """Write the views layout (or, with ``indexed``, the indexed one) into
    ``out_dir``: len(sources) x n_views pairs, seeded per (seed, mesh,
    view). Returns the pair count."""
    dev = _device.resolve(device)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for m, path in enumerate(sources):
        v, f = objio.read_obj(path)
        n = _base_normals(v, f, dev)
        for view_i in range(n_views):
            rng = np.random.default_rng((seed, m, view_i))
            view = make_view(v, n, rng, num_points, rot_mag, trans_mag,
                             noise_type, jitter_scale, keep_ratio, dev)
            if indexed:
                stem_src = f"{count}_src_sample"
                stem_tar = f"{count}_tar_sample"
                stem_tf = f"{count}_transform"
            else:
                stem_src = f"src_sample_{m}_{view_i}"
                stem_tar = f"tar_sample_{m}_{view_i}"
                stem_tf = f"transform_{m}_{view_i}"
            write_view(out_dir, stem_src, stem_tar, stem_tf, view,
                       num_sample, num_neigh, dev)
            count += 1
            log(f"[{count}] {os.path.basename(path)} view {view_i} -> "
                f"{stem_src}.obj (+normals, neigh.bin, {stem_tf}.bin)")
    log(f"wrote {count} pairs to {out_dir}")
    return count


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sources", required=True,
                    help="glob of base clouds/meshes (.obj)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_views", type=int, default=10)
    ap.add_argument("--num_points", type=int, default=2048)
    ap.add_argument("--rot_mag", type=float, default=45.0,
                    help="max view rotation (degrees)")
    ap.add_argument("--trans_mag", type=float, default=0.5)
    ap.add_argument("--noise_type", default="clean",
                    choices=["clean", "jitter", "crop"])
    ap.add_argument("--jitter_scale", type=float, default=0.01)
    ap.add_argument("--keep_ratio", type=float, default=0.7)
    ap.add_argument("--num_sample", type=int, default=5000,
                    help="neighbour-precompute seed count")
    ap.add_argument("--num_neigh", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--indexed", action="store_true",
                    help="write the {i}_src_sample.obj indexed layout instead "
                         "of the views layout")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; fails without one) or cpu (the plain path)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    sources = sorted(glob.glob(args.sources))
    if not sources:
        raise SystemExit(f"no sources match {args.sources}")
    return build(sources, args.out, args.n_views, args.num_points, args.rot_mag,
                 args.trans_mag, args.noise_type, args.jitter_scale, args.keep_ratio,
                 args.num_sample, args.num_neigh, args.seed, args.indexed, device=dev)


if __name__ == "__main__":
    main()
