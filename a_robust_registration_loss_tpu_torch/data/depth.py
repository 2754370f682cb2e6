"""Depth-capture data generation: pinhole back-projection, depth-
discontinuity meshing, vertex normals, FPS sampling.

Port of ``a_robust_registration_loss_tpu/data/depth.py`` (the reference's
real-scan pipeline, utils.py:108-151, 404-534). Back-projection and meshing
are vectorised numpy, the same as there: a pixel becomes a vertex iff it
belongs to a fully valid 2x2 quad and the 4-neighbour Laplacian of every
channel is below ``thresh``; faces are the two triangles of each quad whose
corners all survived, in the reference's order. The vertex normals and the
FPS run on ``device``, the card unless "cpu".

Intrinsics default to the reference's capture rig. Quirk kept: the pixel
grid is ``np.linspace(0, W, W)`` (step W/(W-1)), not arange;
``exact_grid=False`` takes arange.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.data import objio
from a_robust_registration_loss_tpu_torch.ops import geometry as G


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    fx: float = 5.40021232e2     # utils.py:434-438
    fy: float = 5.70342205e2
    cx: float = 3.20000000e2
    cy: float = 240.0
    depth_scale: float = 1000.0  # mm -> m (utils.py:483 "/1000")


def backproject_depth(depth, intr: Intrinsics = Intrinsics(), border: int = 3,
                      exact_grid: bool = True):
    """Depth image (H, W) -> ((H, W, 3) camera-frame points, (H, W) mask).

    Mask = positive depth AND >= ``border`` pixels from the image edge
    (the reference's temp_mask, utils.py:474-476)."""
    depth = np.asarray(depth, np.float64)
    H, W = depth.shape
    if exact_grid:
        x = np.broadcast_to(np.linspace(0, W, W)[None, :], (H, W))
        y = np.broadcast_to(np.linspace(0, H, H)[:, None], (H, W))
    else:
        x = np.broadcast_to(np.arange(W, dtype=np.float64)[None, :], (H, W))
        y = np.broadcast_to(np.arange(H, dtype=np.float64)[:, None], (H, W))
    z = depth
    mask = (z > 0).astype(np.float64)
    border_mask = np.zeros((H, W))
    border_mask[border : H - border, border : W - border] = 1.0
    mask = mask * border_mask
    px = (x - intr.cx) * z / intr.fx * mask
    py = (y - intr.cy) * z / intr.fy * mask
    pz = z * mask
    pts = np.stack([px, py, pz], -1) / intr.depth_scale
    return pts, mask


def depth_mesh(points_img, mask, thresh: float = 0.1):
    """Triangulate a masked (H, W, 3) point image into (V (N, 3), F (M, 3)),
    rejecting depth discontinuities — vectorized generate_depth_mesh
    (utils.py:108-151)."""
    pts = np.asarray(points_img, np.float64)
    valid = np.asarray(mask).reshape(pts.shape[:2]) > 0
    H, W = valid.shape

    # fully-valid 2x2 quads, padded back to vertex-level membership
    q = valid[:-1, :-1] & valid[:-1, 1:] & valid[1:, :-1] & valid[1:, 1:]
    # vertex (i, j) belongs to quads (i-1..i, j-1..j): T1..T4 of the reference
    in_quad = np.zeros((H, W), bool)
    in_quad[: H - 1, : W - 1] |= q          # T1: quad at (i, j)
    in_quad[1:, 1:] |= q                    # T2: quad at (i-1, j-1)
    in_quad[1:, : W - 1] |= q               # T3: quad at (i-1, j)
    in_quad[: H - 1, 1:] |= q               # T4: quad at (i, j-1)

    # 4-neighbor Laplacian rejection on every channel (utils.py:132-140)
    lap_ok = np.zeros((H, W), bool)
    inner = np.s_[1 : H - 1, 1 : W - 1]
    ok = np.ones((H - 2, W - 2), bool)
    for c in range(3):
        ch = pts[..., c]
        lap = np.abs(4 * ch[1:-1, 1:-1] - ch[:-2, 1:-1] - ch[2:, 1:-1]
                     - ch[1:-1, :-2] - ch[1:-1, 2:])
        ok &= lap < thresh
    lap_ok[inner] = ok

    keep = valid & in_quad & lap_ok
    ids = np.full((H, W), -1, np.int64)
    ids[keep] = np.arange(int(keep.sum()))
    V = pts[keep].astype(np.float32)

    # faces of each quad whose three corners survived (utils.py:143-151)
    a = ids[: H - 1, : W - 1]
    b = ids[1:, : W - 1]
    c_ = ids[1:, 1:]
    d = ids[: H - 1, 1:]
    t1 = (a >= 0) & (b >= 0) & (c_ >= 0)
    t2 = (a >= 0) & (c_ >= 0) & (d >= 0)
    # row-major, T1-then-T2 per pixel — the reference's emission order
    # (utils.py:143-151), so faces compare exactly against it
    cand = np.stack([
        np.stack([a, b, c_], -1),
        np.stack([a, c_, d], -1),
    ], axis=2)  # (H-1, W-1, 2, 3)
    keep_f = np.stack([t1, t2], axis=2)  # (H-1, W-1, 2)
    F = cand[keep_f].astype(np.int32).reshape(-1, 3)
    return V, F


def sample_points_normals(points, normals, num: int, start_idx=None, device=None):
    """FPS-select ``num`` points (from ``start_idx``, default 0) carrying
    their normals; FPS runs on ``device``."""
    dev = _device.resolve(device)
    pts = torch.as_tensor(np.asarray(points, np.float32)).to(dev)[None]
    if start_idx is not None:
        start_idx = torch.as_tensor(start_idx).to(dev)
    idx = G.farthest_point_sample(pts, num, start_idx)[0]
    p = pts[0, idx].cpu().numpy()
    n = np.asarray(normals)[idx.cpu().numpy()]
    return p, n


def mesh_vertex_normals(V, F, device=None):
    """Area-weighted vertex normals (the reference's trimesh
    vertex_normals) on ``device``."""
    dev = _device.resolve(device)
    return G.vertex_normals(torch.as_tensor(np.asarray(V, np.float32)).to(dev),
                            torch.as_tensor(np.asarray(F)).to(dev)).cpu().numpy()


def read_depth_png(path: str):
    """16-bit depth PNG -> (H, W) array (cv.imread IMREAD_UNCHANGED role,
    utils.py:514)."""
    try:
        from PIL import Image

        return np.asarray(Image.open(path))
    except ImportError:
        import imageio.v2 as imageio  # type: ignore

        return np.asarray(imageio.imread(path))


def capture_to_sample(depth, out_prefix: str,
                      intr: Intrinsics = Intrinsics(), num: int = 2048,
                      subset: int = 15000, thresh: float = 0.1,
                      rng: Optional[np.random.Generator] = None,
                      pose_path: Optional[str] = None, device=None):
    """One capture (an array or a PNG path) -> backproject -> mesh ->
    vertex normals -> a random ``subset`` (drawn with replacement, as the
    reference does) -> FPS to ``num`` -> ``{out_prefix}_sample.obj`` +
    ``{out_prefix}_sample_normals.obj``.

    Returns (points (num, 3), normals (num, 3), pose or None), or three
    Nones for an empty mesh or NaN normals (the reference skips those)."""
    rng = np.random.default_rng() if rng is None else rng
    if isinstance(depth, str):
        depth = read_depth_png(depth)
    pts_img, mask = backproject_depth(depth, intr)
    V, F = depth_mesh(pts_img, mask, thresh)
    if V.shape[0] == 0:
        return None, None, None
    normals = mesh_vertex_normals(V, F, device)
    index = rng.choice(np.arange(V.shape[0]), size=min(subset, V.shape[0]))
    Vs, Ns = V[index], normals[index]
    p, n = sample_points_normals(Vs, Ns, num, device=device)
    if np.isnan(n).sum() > 0:
        return None, None, None
    objio.write_obj(out_prefix + "_sample.obj", p)
    objio.write_obj(out_prefix + "_sample_normals.obj", n)
    pose = np.loadtxt(pose_path) if pose_path and os.path.exists(pose_path) \
        else None
    return p, n, pose


def main(argv=None):
    """Batch depth-capture CLI: every ``*depth.png`` under --data_path
    becomes ``{stem}_sample.obj`` + ``{stem}_sample_normals.obj``; poses
    from the ``pose.txt`` companions go into poses.json."""
    import argparse
    import glob
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--pattern", default="*depth.png")
    ap.add_argument("--num", type=int, default=2048)
    ap.add_argument("--subset", type=int, default=15000)
    ap.add_argument("--fx", type=float, default=Intrinsics.fx)
    ap.add_argument("--fy", type=float, default=Intrinsics.fy)
    ap.add_argument("--cx", type=float, default=Intrinsics.cx)
    ap.add_argument("--cy", type=float, default=Intrinsics.cy)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; fails without one) or cpu (the plain path)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    intr = Intrinsics(fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy)
    rng = np.random.default_rng(args.seed)
    poses = {}
    paths = sorted(glob.glob(os.path.join(args.data_path, args.pattern)))
    if not paths:
        raise SystemExit(f"no depth images matching {args.pattern}")
    for idx, p in enumerate(paths):
        prefix = p[: -len(".png")]
        pose_path = p.replace("depth.png", "pose.txt")
        pts, _, pose = capture_to_sample(
            p, prefix, intr, num=args.num, subset=args.subset, rng=rng,
            pose_path=pose_path, device=dev)
        if pts is None:
            print(f"skip (empty/NaN): {p}")
            continue
        if pose is not None:
            poses[os.path.basename(p)] = np.asarray(pose).tolist()
        print(f"[{idx}] wrote {prefix}_sample.obj")
    with open(os.path.join(args.data_path, "poses.json"), "w") as f:
        json.dump(poses, f, indent=1)


def make_sample_data(V, F, num: int = 1024, device=None):
    """Mesh -> (FPS points, normals), or (None, None) on NaN normals."""
    normals = mesh_vertex_normals(V, F, device)
    p, n = sample_points_normals(np.asarray(V, np.float32), normals, num, device=device)
    if np.isnan(n).sum() > 0:
        return None, None
    return p, n


if __name__ == "__main__":
    main()
