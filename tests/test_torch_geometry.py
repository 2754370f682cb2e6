"""The port's ops/geometry.py against the JAX package.

FPS, kNN and sample_neighs indices exactly equal (FPS takes the first
argmax; kNN keeps lax.top_k's tie order through a stable sort), bbox faces
exactly equal, chamfer distance rtol 1e-5 (reductions in another order).
On CPU tensors the routed FPS and chamfer distance are their plain versions
bit for bit and launch nothing; the chamfer kernel's split at the callers'
shapes is one that timed within 5% of the fastest on the H100.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import geometry as JG
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops.cuda import chamfer as CH
from a_robust_registration_loss_tpu_torch.ops.cuda import fps as FK
from torch_port_helpers import sphere_cloud, t

torch.set_num_threads(1)


@pytest.fixture
def clouds():
    rng = np.random.default_rng(11)
    return (sphere_cloud(300, rng, noise=0.03),
            sphere_cloud(260, rng, noise=0.03) * np.float32(1.3))


FPS_ENTRIES = {"geometry": G.farthest_point_sample, "wrapper": FK.farthest_point_sample,
               "plain": G.farthest_point_sample_reference}


@pytest.mark.parametrize("entry", list(FPS_ENTRIES))
@pytest.mark.parametrize("npoint,with_start", [(64, True), (64, False), (253, True)])
def test_farthest_point_sample_exact(clouds, entry, npoint, with_start):
    # every entry on a CPU tensor is the plain loop, and launches nothing;
    # npoint > N keeps picking once every point is taken
    xyz = np.stack([clouds[0][:250], clouds[1][:250]])
    start = np.array([0, 17], np.int32) if with_start else None
    before = FK.launches["kernel"]
    got = FPS_ENTRIES[entry](t(xyz), npoint, None if start is None else t(start)).numpy()
    ref = np.asarray(JG.farthest_point_sample(jnp.asarray(xyz), npoint,
                                              None if start is None else jnp.asarray(start)))
    np.testing.assert_array_equal(got, ref)
    assert FK.launches["kernel"] == before


@pytest.mark.parametrize("shape,start", [((250, 3), None), ((2, 250, 4), None),
                                         ((2, 250, 3), [0, 1, 2]), ((2, 250, 3), [5]),
                                         ((2, 250, 3), 3)],
                         ids=["no_batch_axis", "four_columns", "start_too_long",
                              "start_too_short", "start_scalar"])
def test_farthest_point_sample_raises_on_a_wrong_shape(shape, start):
    # checked before the route is chosen, so on the CPU too
    with pytest.raises(ValueError):
        FK.farthest_point_sample(torch.zeros(shape), 8, start)
    with pytest.raises(ValueError):
        G.farthest_point_sample(torch.zeros(shape), 8, start)


def test_knn_exact_including_ties():
    # a lattice has many exactly equal distances: the lower index comes first
    g = np.arange(4, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    query = pts[::5] + np.float32(0.5)
    dj, ij = JG.knn_points(jnp.asarray(query), jnp.asarray(pts), 6)
    dt, it = G.knn_points(t(query), t(pts), 6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)


def test_sample_neighs_exact(clouds):
    for cloud, n in ((clouds[0], 128), (clouds[1], 300)):  # 300 > N: capped
        got = G.sample_neighs(t(cloud), n, 3).numpy()
        ref = np.asarray(JG.sample_neighs(jnp.asarray(cloud), n, 3))
        np.testing.assert_array_equal(got, ref)


def test_bbox_faces_exact(clouds):
    v = np.stack([clouds[0][:200], clouds[1][:200]])
    np.testing.assert_array_equal(G.bounding_box_corners(t(v)).numpy(),
                                  np.asarray(JG.bounding_box_corners(jnp.asarray(v))))
    np.testing.assert_array_equal(G.bbox_face_vertices(t(v)).numpy(),
                                  np.asarray(JG.bbox_face_vertices(jnp.asarray(v))))
    np.testing.assert_array_equal(G.BBOX_FACES, JG.BBOX_FACES)


def test_chamfer_and_square_distance(clouds):
    a, b = clouds[0][None], clouds[1][None]
    np.testing.assert_allclose(
        float(G.chamfer_distance(t(a), t(b))),
        float(JG.chamfer_distance(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(
        G.square_distance(t(a), t(b)).numpy(),
        np.asarray(JG.square_distance(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)


CHAMFER_ENTRIES = {"geometry": G.chamfer_distance, "wrapper": CH.chamfer_distance}


@pytest.mark.parametrize("entry", list(CHAMFER_ENTRIES))
@pytest.mark.parametrize("per_sample", [False, True], ids=["batch", "per_sample"])
def test_chamfer_on_cpu_is_the_plain_path(clouds, entry, per_sample):
    # every entry on a CPU tensor is the plain matrix-and-amin version bit for
    # bit, with its gradient, and launches nothing; per sample as B calls
    x = t(np.stack([clouds[0][:250], clouds[1][:250]])).requires_grad_(True)
    y = t(np.stack([clouds[1][:200], clouds[0][:200]]))
    before = dict(CH.launches)
    got = CHAMFER_ENTRIES[entry](x, y, per_sample=per_sample)
    sq = G.square_distance(x, y)
    d1, d2 = sq.amin(2), sq.amin(1)
    want = (torch.cat([d1, d2], -1).mean(-1) if per_sample
            else torch.cat([d1.reshape(-1), d2.reshape(-1)]).mean())
    assert torch.equal(got, want)
    assert torch.equal(got, G.chamfer_distance_reference(x, y, per_sample))
    if per_sample:
        for b in range(2):
            assert torch.equal(got[b], G.chamfer_distance(x[b:b + 1], y[b:b + 1]))
    (g,) = torch.autograd.grad(got.sum(), x)
    (w,) = torch.autograd.grad(want.sum(), x)
    assert torch.equal(g, w)
    assert CH.launches == before


def test_chamfer_raises_off_the_cpu_and_the_card():
    x = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError):
        G.chamfer_distance(x, x)
    with pytest.raises(ValueError):
        G.chamfer_distance(torch.zeros((1, 8, 3)), x)


@pytest.mark.parametrize("shape,want", [
    ((1, 8192, 8192), 4),  # the classical step's monitor
    ((8, 8192, 8192), 1),  # 8 such pairs (run_batch)
    ((4, 1024, 1024), 8),  # DCP's train monitor
    ((8, 717, 717), 8),    # RPM-Net's
    ((16, 717, 717), 4),   # RPM-Net's eval
    ((3, 1000, 2500), 8),
    ((32, 1024, 1024), 1),  # DCP's batch-32 train monitor
])
def test_chamfer_plan(shape, want):
    # on the H100's 132 SMs, each split timed within 5% of the fastest of
    # 1, 2, 4 and 8; DCP's batch-32 monitor fills the SMs unsplit
    assert CH.plan(*shape, 132) == want


def test_index_points_and_make_face_vertices():
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((2, 9, 4)).astype(np.float32)
    idx = rng.integers(0, 9, (2, 3, 5)).astype(np.int64)
    np.testing.assert_array_equal(G.index_points(t(pts), t(idx)).numpy(),
                                  np.asarray(JG.index_points(jnp.asarray(pts), jnp.asarray(idx))))
    faces = rng.integers(0, 9, (2, 6, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        G.make_face_vertices(t(pts[..., :3]), t(faces)).numpy(),
        np.asarray(JG.make_face_vertices(jnp.asarray(pts[..., :3]), jnp.asarray(faces))))
