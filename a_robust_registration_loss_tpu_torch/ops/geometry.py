"""Geometry primitives of the registration paths, the data layer and
RPM-Net: pairwise distances, FPS, k-NN, FPS+kNN neighbourhoods, the radius
ball query and PointNet++ grouping, bounding boxes and their 12-triangle
meshes, chamfer distance, vertex normals of a mesh and PCA normals of a
bare cloud.

Port of ``a_robust_registration_loss_tpu/ops/geometry.py``. Indices follow
the JAX package exactly: FPS takes the first argmax (``torch.argmax`` does
too), and kNN keeps ``lax.top_k``'s tie order, lower index first, through a
stable ascending sort (``torch.topk`` leaves the order of ties
unspecified). Indices are int64, PyTorch's index type.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def square_distance(src, dst):
    """(..., N, C) x (..., M, C) -> (..., N, M) squared euclidean distances
    via the inner-product expansion (fp32 matmul: TF32 is off)."""
    d = -2.0 * (src @ dst.transpose(-1, -2))
    d = d + (src**2).sum(-1)[..., :, None]
    d = d + (dst**2).sum(-1)[..., None, :]
    return d


def index_points(points, idx):
    """Per-batch-row gather: points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B = points.shape[0]
    flat = idx.reshape(B, -1)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(idx.shape + (points.shape[-1],))


def farthest_point_sample(xyz, npoint: int, start_idx=None):
    """Greedy farthest-point sampling: xyz (B, N, 3) -> (B, npoint) int64.

    Seeds at ``start_idx`` ((B,) or None for 0). Routed by
    ``ops/cuda/fps.py``: one launch of the kernel ``csrc/fps.cu`` for a
    CUDA tensor, the plain loop below for a CPU tensor."""
    # imported here: ops/cuda/fps.py imports this module for the plain loop
    from a_robust_registration_loss_tpu_torch.ops.cuda import fps

    return fps.farthest_point_sample(xyz, npoint, start_idx)


def farthest_point_sample_reference(xyz, npoint: int, start_idx=None):
    """The plain version of ``farthest_point_sample``: a Python loop of
    npoint steps with no host sync, the running argmax on the device. The
    CPU route, and the kernel's yardstick on the card."""
    B, N, _ = xyz.shape
    if start_idx is None:
        farthest = torch.zeros(B, dtype=torch.long, device=xyz.device)
    else:
        farthest = torch.as_tensor(start_idx, device=xyz.device).long()
    centroids = torch.empty((B, npoint), dtype=torch.long, device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        centroids[:, i] = farthest
        centroid = xyz[rows, farthest][:, None, :]
        dist = ((xyz - centroid) ** 2).sum(-1)
        distance = torch.minimum(distance, dist)
        farthest = torch.argmax(distance, dim=-1)
    return centroids


def sample_points(points, npoints: int, start_idx=None):
    """FPS-select npoints rows of points (B, N, C)."""
    return index_points(points, farthest_point_sample(points, npoints,
                                                      start_idx))


def knn_points(query, points, k: int):
    """Brute-force k-NN: query (..., S, 3), points (..., N, 3) ->
    (dists (..., S, k), idx (..., S, k)), ascending, ties lower index
    first."""
    d = square_distance(query, points)
    srt = torch.sort(d, dim=-1, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]


def sample_neighs(points, num_sample: int = 5000, num_neigh: int = 3,
                  start_idx=None):
    """FPS-sample num_sample seeds, k-NN each against the full cloud, and
    return the flattened (num_sample*num_neigh, 3) neighbourhood array,
    row-major [n0_of_s0, n1_of_s0, n2_of_s0, n0_of_s1, ...]. The first
    neighbour of each seed is the seed itself."""
    pts = points[None] if points.ndim == 2 else points
    n = min(num_sample, pts.shape[1])
    seeds = sample_points(pts, n, start_idx)
    _, idx = knn_points(seeds, pts, num_neigh)
    neigh = index_points(pts, idx.reshape(pts.shape[0], -1))
    neigh = neigh.reshape(pts.shape[0], n * num_neigh, 3)
    return neigh[0] if points.ndim == 2 else neigh


def query_ball_point(radius, nsample: int, xyz, new_xyz):
    """Radius grouping with sort-truncate-backfill: (B, S, nsample) indices
    into xyz (B, N, 3) of the points within ``radius`` of each query point
    of new_xyz (B, S, 3), ascending; a ball with fewer than nsample points
    repeats its first one. An empty ball gives N - 1 throughout: the
    reference leaves its out-of-range sentinel N there, and the JAX package
    clamps it to N - 1 (a documented divergence, kept)."""
    N = xyz.shape[1]
    sqrdists = square_distance(new_xyz, xyz)
    group_idx = torch.arange(N, device=xyz.device).expand(sqrdists.shape)
    group_idx = torch.where(sqrdists > radius**2, N, group_idx)
    group_idx = _smallest_k(group_idx, nsample)
    group_idx = torch.where(group_idx == N, group_idx[..., :1], group_idx)
    return group_idx.clamp_max(N - 1)


def _smallest_k(values, k: int):
    """The k smallest values along the last axis, ascending: the values of
    a full ascending sort's first k, by a k-selection (``torch.topk`` with
    ``largest=False``) and no sort of the whole row. Only the values are
    read, so the order ``topk`` gives ties does not matter."""
    return torch.topk(values, k, dim=-1, largest=False, sorted=True).values


def sample_and_group(npoint: int, radius, nsample: int, xyz, points=None,
                     returnfps: bool = False, start_idx=None):
    """PointNet++ set abstraction: FPS npoint centres, ball-query nsample
    neighbours of each, coordinates relative to the centre, with the
    neighbours' features ``points`` (B, N, D) appended when given.
    xyz (B, N, 3) -> (new_xyz (B, npoint, 3), new_points (B, npoint,
    nsample, 3[+D])), plus (grouped_xyz, fps_idx) with ``returnfps``."""
    fps_idx = farthest_point_sample(xyz, npoint, start_idx)
    new_xyz = index_points(xyz, fps_idx)
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx)
    new_points = grouped_xyz - new_xyz[:, :, None, :]
    if points is not None:
        new_points = torch.cat([new_points, index_points(points, idx)], -1)
    if returnfps:
        return new_xyz, new_points, grouped_xyz, fps_idx
    return new_xyz, new_points


def sample_and_group_all(xyz, points=None):
    """One group of the whole cloud around the origin: xyz (B, N, 3) ->
    (zeros (B, 1, 3), (B, 1, N, 3[+D]))."""
    B, N, C = xyz.shape
    new_xyz = xyz.new_zeros((B, 1, C))
    new_points = xyz[:, None]
    if points is not None:
        new_points = torch.cat([new_points, points.reshape(B, 1, N, -1)], -1)
    return new_xyz, new_points


def bounding_box_corners(vertices):
    """8 AABB corners, (B, N, 3) -> (B, 8, 3): corner 0 is the max, corner 7
    the min, so ||c0 - c7|| is the diagonal. Corner a*4 + b*2 + c takes x, y,
    z from the max (bit 0) or the min (bit 1)."""
    bits, _ = _bbox_tables(vertices.device)
    mn = vertices.amin(dim=1)[..., None, :]
    mx = vertices.amax(dim=1)[..., None, :]
    return torch.where(bits, mn, mx)


# Fixed 12-triangle topology over the 8 bbox corners.
BBOX_FACES = np.array(
    [[2, 0, 6], [0, 4, 6], [5, 4, 0], [5, 0, 1], [6, 4, 5], [5, 7, 6],
     [3, 0, 2], [1, 0, 3], [3, 2, 6], [6, 7, 3], [5, 1, 3], [3, 7, 5]],
    dtype=np.int32,
)


def make_face_vertices(vertices, faces):
    """Gather faces (B, F, 3) of vertex indices from vertices (B, V, 3)
    into (B, F, 9) coordinate 9-tuples."""
    B = vertices.shape[0]
    idx = faces.reshape(B, -1, 1).long().expand(-1, -1, 3)
    gathered = torch.gather(vertices, 1, idx)
    return gathered.reshape(B, faces.shape[-2], 9)


def bbox_face_vertices(vertices):
    """AABB corners -> the 12-triangle face-vertex tensor (B, 12, 9) of the
    line resampler's coarse hit test."""
    _, faces = _bbox_tables(vertices.device)
    corners = bounding_box_corners(vertices)
    return corners[:, faces].reshape(vertices.shape[0], 12, 9)


@functools.lru_cache(maxsize=None)
def _bbox_tables(device):
    """The corner bits (8, 3) and the flat face-corner indices (36,) on
    ``device``, copied there once: a copy from pageable host memory
    synchronises the stream, and the bounding boxes are taken every step."""
    bits = torch.tensor([[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)],
                        dtype=torch.bool)
    faces = torch.as_tensor(BBOX_FACES.reshape(-1), dtype=torch.long)
    return bits.to(device), faces.to(device)


def chamfer_distance(points_x, points_y, per_sample: bool = False):
    """Mean over the concatenation of the two directions' nearest-neighbour
    squared distances: points_x (B, M, 3), points_y (B, N, 3). A scalar over
    the whole batch, or with ``per_sample`` one value per sample (B,), as
    B separate calls give.

    Routed by ``ops/cuda/chamfer.py``: one launch of the kernel
    ``csrc/chamfer.cu`` for CUDA tensors (no gradient), the plain version
    below for CPU tensors."""
    # imported here: ops/cuda/chamfer.py imports this module for the plain version
    from a_robust_registration_loss_tpu_torch.ops.cuda import chamfer

    return chamfer.chamfer_distance(points_x, points_y, per_sample)


def chamfer_distance_reference(points_x, points_y, per_sample: bool = False):
    """The plain version of ``chamfer_distance``: the (B, M, N) matrix of
    ``square_distance`` and its two minima. The CPU route, and the kernel's
    yardstick on the card."""
    sqrdis = square_distance(points_x, points_y)
    d1 = sqrdis.amin(dim=2)
    d2 = sqrdis.amin(dim=1)
    if per_sample:
        return torch.cat([d1, d2], dim=-1).mean(-1)
    return torch.cat([d1.reshape(-1), d2.reshape(-1)]).mean()


def vertex_normals(vertices, faces):
    """Area-weighted unit vertex normals of a mesh: each face's cross
    product scatter-added onto its three corners (``index_add_``).
    vertices (N, 3), faces (F, 3) -> (N, 3); a vertex on no face gets 0."""
    faces = faces.long()
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    n = torch.zeros_like(vertices)
    for i in range(3):
        n.index_add_(0, faces[:, i], fn)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.where(norm == 0, 1.0, norm)


def estimate_normals(points, k: int = 16):
    """Per-point unit normals by local PCA: the eigenvector of the least
    eigenvalue of each point's k-NN covariance (``torch.linalg.eigh``,
    ascending), oriented away from the cloud's centroid. points (N, 3) or
    (B, N, 3) -> the same shape. An eigenvector's sign, and the basis of a
    repeated eigenvalue, are free: compare normals by |n . n'|."""
    pts = points[None] if points.ndim == 2 else points
    B, N, _ = pts.shape
    _, idx = knn_points(pts, pts, k)          # (B, N, k), self included
    nbrs = index_points(pts, idx.reshape(B, -1)).reshape(B, N, k, 3)
    centered = nbrs - nbrs.mean(dim=2, keepdim=True)
    cov = centered.transpose(-1, -2) @ centered
    _, vecs = torch.linalg.eigh(cov)
    n = vecs[..., :, 0]
    outward = pts - pts.mean(dim=1, keepdim=True)
    n = torch.where((n * outward).sum(-1, keepdim=True) < 0, -n, n)
    return n[0] if points.ndim == 2 else n
