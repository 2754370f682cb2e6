"""Headless point-cloud visualisation.

Port of ``a_robust_registration_loss_tpu/utils/viz.py``:
:func:`plot_clouds` renders clouds to a PNG (matplotlib's Agg backend,
imported only when called), and :func:`draw_registration_result` writes the
``source_pre.ply`` / ``source.ply`` / ``target.ply`` triple with the
reference's uniform colours, plus the PNG overlay when asked.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# the reference's open3d paint_uniform_color values
SOURCE_COLOR = (1.0, 0.706, 0.0)
TARGET_COLOR = (0.0, 0.651, 0.929)


def plot_clouds(clouds: Sequence, path: str, labels: Optional[Sequence[str]] = None,
                colors: Optional[Sequence] = None, point_size: float = 1.0,
                elev: float = 20.0, azim: float = -60.0):
    """Render one or more (N, 3) clouds into a PNG at ``path``, with equal
    axes. Returns the saved path."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    default_colors = [SOURCE_COLOR, TARGET_COLOR, (0.8, 0.2, 0.2),
                      (0.3, 0.7, 0.3)]
    for i, cloud in enumerate(clouds):
        v = np.asarray(cloud, np.float32).reshape(-1, 3)
        c = (colors[i] if colors is not None
             else default_colors[i % len(default_colors)])
        ax.scatter(v[:, 0], v[:, 1], v[:, 2], s=point_size, color=c,
                   label=(labels[i] if labels else None), depthshade=False)
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    ax.view_init(elev=elev, azim=azim)
    if labels:
        ax.legend(loc="upper right")
    allv = np.concatenate([np.asarray(c).reshape(-1, 3) for c in clouds])
    ctr = (allv.max(0) + allv.min(0)) / 2
    r = float((allv.max(0) - allv.min(0)).max()) / 2 or 1.0
    ax.set_xlim(ctr[0] - r, ctr[0] + r)
    ax.set_ylim(ctr[1] - r, ctr[1] + r)
    ax.set_zlim(ctr[2] - r, ctr[2] + r)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def draw_registration_result(source, target, transform, out_dir: str,
                             png: bool = True):
    """Write ``source_pre.ply`` (untransformed, source colour),
    ``source.ply`` (transformed), ``target.ply`` (target colour) and, with
    ``png``, ``registration.png`` overlaying the transformed source on the
    target. Returns the written paths by name.

    ``transform``: (4, 4) or (3, 4) homogeneous map applied to row-vector
    points as p' = R p + t (column convention, like open3d's .transform)."""
    from a_robust_registration_loss_tpu_torch.data import plyio

    src = np.asarray(source, np.float32).reshape(-1, 3)
    tar = np.asarray(target, np.float32).reshape(-1, 3)
    g = np.asarray(transform, np.float32)
    R, t = g[:3, :3], g[:3, 3]
    src_t = src @ R.T + t

    os.makedirs(out_dir, exist_ok=True)
    plyio.write_ply(os.path.join(out_dir, "source_pre.ply"), src,
                    colors=SOURCE_COLOR)
    plyio.write_ply(os.path.join(out_dir, "source.ply"), src_t,
                    colors=SOURCE_COLOR)
    plyio.write_ply(os.path.join(out_dir, "target.ply"), tar,
                    colors=TARGET_COLOR)
    out = {"source_pre": os.path.join(out_dir, "source_pre.ply"),
           "source": os.path.join(out_dir, "source.ply"),
           "target": os.path.join(out_dir, "target.ply")}
    if png:
        out["png"] = plot_clouds(
            [src_t, tar], os.path.join(out_dir, "registration.png"),
            labels=["source (transformed)", "target"])
    return out
