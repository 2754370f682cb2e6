"""The port's ops/geometry.py against the JAX package.

FPS, kNN and sample_neighs indices exactly equal (FPS takes the first
argmax; kNN keeps lax.top_k's tie order through a stable sort), bbox faces
exactly equal, chamfer distance rtol 1e-5 (reductions in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import geometry as JG
from a_robust_registration_loss_tpu_torch.ops import geometry as G
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
    before = FK.launches
    got = FPS_ENTRIES[entry](t(xyz), npoint, None if start is None else t(start)).numpy()
    ref = np.asarray(JG.farthest_point_sample(jnp.asarray(xyz), npoint,
                                              None if start is None else jnp.asarray(start)))
    np.testing.assert_array_equal(got, ref)
    assert FK.launches == before


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
