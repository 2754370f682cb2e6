"""The port's dataset builders (data/make_dataset.py, data/depth.py), its
native OBJ IO and its normals (ops/geometry.py) against the JAX package's,
on the CPU.

``make_dataset.build`` in both packages from the same base clouds (a bare
noisy ellipsoid, which takes the PCA normals, and a triangulated one with
noisy vertices, which takes the vertex normals) and seed writes EQUAL
points, neighbour buffers and transform files; the normals agree within
|n . n'| >= 1 - 1e-4 (an eigenvector's sign and a scatter-add's order are
free) [measured below 1e-6]. ``depth``'s back-projection and mesh are equal, and so are
``capture_to_sample``'s points, its normals within 1e-5. The native OBJ IO
writes the pure-Python path's bytes, reads the JAX writer's files to the
same arrays, and raises on a missing file.

The mesh's vertices carry noise: on an exact lattice FPS meets squared
distances one ulp apart, and XLA:CPU, which contracts multiply-adds into
FMAs, rounds them otherwise than IEEE arithmetic does, so the JAX package
on the CPU picks the other point of such a near-tie (ROADMAP.md Queue 3).
``test_fps_on_a_lattice_is_ieee`` holds the port's FPS on the exact
lattice to a float32 numpy replay without FMA instead.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from a_robust_registration_loss_tpu.data import depth as JD
from a_robust_registration_loss_tpu.data import make_dataset as JMK
from a_robust_registration_loss_tpu.data import objio as JO
from a_robust_registration_loss_tpu.ops import geometry as JG
from a_robust_registration_loss_tpu_torch.data import depth as D
from a_robust_registration_loss_tpu_torch.data import make_dataset as MK
from a_robust_registration_loss_tpu_torch.data import objio
from a_robust_registration_loss_tpu_torch.native import objio_native
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from torch_port_helpers import sphere_cloud

torch.set_num_threads(1)
DOT_BAR = 1e-4


def ellipsoid_mesh(nu=10, nv=14, noise=0.0):
    """A latitude-longitude triangulated ellipsoid: (V, 3), (F, 3); its
    vertices moved by Gaussian ``noise`` from seed 1."""
    u = np.linspace(0.15, np.pi - 0.15, nu)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    U, W = np.meshgrid(u, v, indexing="ij")
    verts = np.stack([np.sin(U) * np.cos(W), 0.8 * np.sin(U) * np.sin(W), 0.6 * np.cos(U)],
                     -1).reshape(-1, 3)
    verts = (verts + noise * np.random.default_rng(1).standard_normal(verts.shape)).astype(
        np.float32)
    faces = []
    for a in range(nu - 1):
        for b in range(nv):
            i0, i1 = a * nv + b, a * nv + (b + 1) % nv
            faces += [[i0, i0 + nv, i1], [i1, i0 + nv, i1 + nv]]
    return verts, np.asarray(faces, np.int32)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("base")
    rng = np.random.default_rng(0)
    bare = sphere_cloud(160, rng, noise=0.005) * np.float32([1.0, 0.7, 0.5])
    JO.write_obj(str(root / "a_bare.obj"), bare)
    JO.write_obj(str(root / "b_mesh.obj"), *ellipsoid_mesh(noise=0.002))
    return [str(root / "a_bare.obj"), str(root / "b_mesh.obj")]


def _assert_unit_parallel(a, b):
    dots = np.abs((np.asarray(a) * np.asarray(b)).sum(-1))
    assert dots.min() >= 1 - DOT_BAR, dots.min()


@pytest.mark.parametrize("noise,indexed", [("clean", False), ("jitter", True), ("crop", False)])
def test_build_equals_jax(tmp_path, sources, noise, indexed):
    kw = dict(n_views=2, num_points=64, rot_mag=45.0, trans_mag=0.3, noise_type=noise,
              keep_ratio=0.75, num_sample=48, seed=3, indexed=indexed, log=lambda *a: None)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    assert MK.build(sources, str(mine), device="cpu", **kw) == 4
    assert JMK.build(sources, str(theirs), **kw) == 4
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(mine)) == names and len(names) == 4 * 7
    for name in names:
        if name.endswith(".bin"):
            dtype = np.float64 if "transform" in name else np.float32
            a, b = (np.fromfile(str(d / name), dtype) for d in (mine, theirs))
            assert np.array_equal(a, b), name
        elif "normals" in name:
            _assert_unit_parallel(JO.read_obj(str(mine / name))[0],
                                  JO.read_obj(str(theirs / name))[0])
        else:
            assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name


def _fps_numpy(xyz, npoint):
    """FPS in float32 numpy, each operation rounded on its own."""
    dist = np.full(len(xyz), 1e10, np.float32)
    out, far = [], 0
    for _ in range(npoint):
        out.append(far)
        d = xyz - xyz[far]
        d = d * d
        dist = np.minimum(dist, (d[:, 0] + d[:, 1]) + d[:, 2])
        far = int(np.argmax(dist))
    return np.asarray(out)


def test_fps_on_a_lattice_is_ieee():
    v, _ = ellipsoid_mesh()
    R = MK.T._so3_exp(np.array([0.3, -0.2, 0.5]))
    for cloud in (v, (v.astype(np.float64) @ R + 0.1).astype(np.float32)):
        got = G.farthest_point_sample(torch.tensor(cloud)[None], 60)[0].numpy()
        assert np.array_equal(got, _fps_numpy(cloud, 60))


def test_normals_match_jax(sources):
    v, f = JO.read_obj(sources[1])
    got = G.vertex_normals(torch.tensor(v), torch.tensor(f)).numpy()
    want = np.asarray(JG.vertex_normals(jnp.asarray(v), jnp.asarray(f)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    lonely = G.vertex_normals(torch.tensor(np.vstack([v, [[5, 5, 5]]])), torch.tensor(f))
    assert torch.equal(lonely[-1], torch.zeros(3))  # a vertex on no face
    bare = JO.read_obj(sources[0])[0]
    got = G.estimate_normals(torch.tensor(bare)).numpy()
    _assert_unit_parallel(got, np.asarray(JG.estimate_normals(jnp.asarray(bare))))
    outward = bare - bare.mean(0)
    assert ((got * outward).sum(-1) >= 0).all()  # oriented away from the centroid
    batched = G.estimate_normals(torch.tensor(np.stack([bare, bare[::-1].copy()])))
    assert torch.equal(batched[0], torch.tensor(got))


def _depth(H=20, W=24):
    d = 1000.0 + np.arange(H)[:, None] * 2.0 + np.arange(W)[None, :] * 1.0
    d = np.broadcast_to(d, (H, W)).copy()
    d[:, 15:] += 500.0  # a discontinuity the mesh must not bridge
    d[3:6, 4:7] = 0.0   # a hole
    return d


@pytest.mark.parametrize("exact_grid", [True, False])
def test_depth_backprojection_and_mesh_equal_jax(exact_grid):
    got = D.backproject_depth(_depth(), exact_grid=exact_grid)
    want = JD.backproject_depth(_depth(), exact_grid=exact_grid)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    V, F = D.depth_mesh(*got)
    JV, JF_ = JD.depth_mesh(*want)
    assert np.array_equal(V, JV) and np.array_equal(F, JF_) and len(F) > 0


def test_capture_to_sample_equals_jax(tmp_path):
    got = D.capture_to_sample(_depth(), str(tmp_path / "p"), num=40, subset=200,
                              rng=np.random.default_rng(2), device="cpu")
    want = JD.capture_to_sample(_depth(), str(tmp_path / "j"), num=40, subset=200,
                                rng=np.random.default_rng(2))
    assert np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    assert (tmp_path / "p_sample.obj").read_bytes() == (tmp_path / "j_sample.obj").read_bytes()
    assert os.path.exists(tmp_path / "p_sample_normals.obj")
    V, F = ellipsoid_mesh()
    p, n = D.make_sample_data(V, F, num=30, device="cpu")
    jp, jn = JD.make_sample_data(V, F, num=30)
    assert np.array_equal(p, jp)
    np.testing.assert_allclose(n, jn, atol=1e-6)


def test_native_objio_matches_python_and_jax(tmp_path):
    assert objio_native.available() and objio.backend() == "native"
    assert objio_native.LIB_PATH.endswith(os.path.join("build", "torch_native", "libobjio.so"))
    assert not os.path.exists(os.path.join(os.path.dirname(objio_native.SOURCE), "libobjio.so"))
    rng = np.random.default_rng(4)
    v = rng.standard_normal((300, 3)).astype(np.float32)
    f = rng.integers(0, 300, (50, 3)).astype(np.int32)
    for faces in (None, f):
        objio.write_obj(str(tmp_path / "n.obj"), v, faces)
        objio.write_obj_python(str(tmp_path / "p.obj"), v, faces)
        assert (tmp_path / "n.obj").read_bytes() == (tmp_path / "p.obj").read_bytes()
        got, want = objio.read_obj(str(tmp_path / "n.obj")), objio.read_obj_python(
            str(tmp_path / "p.obj"))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    JO.write_obj(str(tmp_path / "j.obj"), v, f)
    with open(tmp_path / "j.obj", "a") as fh:
        fh.write("vn 0 0 1\nf 1/1/1 2/2/2 3/3/3\n# comment\n")
    got, want = objio.read_obj(str(tmp_path / "j.obj")), JO.read_obj(str(tmp_path / "j.obj"))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert got[1].shape == (51, 3)
    with pytest.raises(IOError):
        objio.read_obj(str(tmp_path / "missing.obj"))
    with pytest.raises(OSError):
        objio.read_obj_python(str(tmp_path / "missing.obj"))
