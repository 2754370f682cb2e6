"""The port's line resampler (ops/lines.py, ops/cuda/resample.py) against
the JAX package.

Bars: candidate geometry within 1e-4 and acceptance rate within 10% of the
JAX Pallas kernel (interpret mode) on the same uniforms; the first-n fill
exact on JAX's own (cand, ok); hit labels exact on identical candidates
against the JAX XLA-path ``triangle_hits``.

Labels are not compared one to one against the Pallas kernel: its
barycentric accept A+B+C <= S holds with equality in real arithmetic for
every interior hit, so the label is decided by rounding, and XLA:CPU
contracts the kernel's multiply-adds into FMAs while the port rounds every
operation on its own. On this scene the JAX package's own Pallas (interpret)
and XLA paths label a sizeable share of the same candidates differently,
and it holds them to the same rate bar (tests/test_pallas.py, bench.py's
gate). A batched call of the plain path (leading axis B on every argument,
the trainers' per-sample lines) equals the per-sample loop exactly. The
CUDA kernel and its plain version, which share their arithmetic, are held
to equal candidates and labels bit for bit: ``tests/test_torch_cuda.py``
and chip_smoke.py; ``tests/test_torch_resample.py`` holds the plain
version's labels to the XLA path's on the knife-edge sets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import geometry as JG
from a_robust_registration_loss_tpu.ops import lines as JL
from a_robust_registration_loss_tpu.ops.pallas import resample as JPR
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
from torch_port_helpers import sphere_cloud, t

torch.set_num_threads(1)

R_SPHERE = np.float32(2.2)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    v1 = sphere_cloud(300, rng, noise=0.05)
    v2 = sphere_cloud(300, rng, noise=0.05) + np.float32(0.1)
    fvs1 = np.asarray(JG.bbox_face_vertices(jnp.asarray(v1)[None])[0])
    fvs2 = np.asarray(JG.bbox_face_vertices(jnp.asarray(v2)[None])[0])
    return v1, v2, fvs1, fvs2, v2.mean(0)


@pytest.fixture(scope="module")
def jax_kernel_draw(scene):
    """The JAX Pallas candidate kernel (interpret mode) on one draw."""
    v1, v2, fvs1, fvs2, center = scene
    u4 = np.asarray(jax.random.uniform(jax.random.PRNGKey(11), (4, 4000)))
    cand, ok = JPR.sample_and_hit(
        jnp.asarray(u4), jnp.float32(R_SPHERE), jnp.asarray(center),
        JPR.prep_faces(jnp.asarray(fvs1), jnp.asarray(fvs2)), tc=1024,
        interpret=True)
    return u4, np.asarray(cand), np.asarray(ok)


def test_prep_faces_exact(scene):
    _, _, fvs1, fvs2, _ = scene
    np.testing.assert_array_equal(
        RS.prep_faces(t(fvs1), t(fvs2)).numpy(),
        np.asarray(JPR.prep_faces(jnp.asarray(fvs1), jnp.asarray(fvs2))))


def test_plain_resampler_against_pallas_kernel(scene, jax_kernel_draw):
    _, _, fvs1, fvs2, center = scene
    u4, cand_j, ok_j = jax_kernel_draw
    cand, ok = RS.sample_and_hit(t(u4), float(R_SPHERE), t(center),
                                 RS.prep_faces(t(fvs1), t(fvs2)))
    np.testing.assert_allclose(cand.numpy(), cand_j, rtol=0, atol=1e-4)
    acc, acc_j = float(ok.float().mean()), float(ok_j.mean())
    assert acc_j > 0.05
    assert abs(acc - acc_j) <= 0.1 * acc_j, (acc, acc_j)


def test_hit_labels_exact_on_identical_candidates(scene, jax_kernel_draw):
    """Given the same candidates, the port's hit test and the JAX XLA-path
    triangle_hits label every candidate alike, and the plain resampler's
    prepped-face test equals the in-line one."""
    _, _, fvs1, fvs2, center = scene
    _, cand_j, _ = jax_kernel_draw
    for fvs in (fvs1, fvs2):
        np.testing.assert_array_equal(
            LN.triangle_hits(t(fvs), t(cand_j)).numpy(),
            np.asarray(JL.triangle_hits(jnp.asarray(fvs), jnp.asarray(cand_j))))
    u4 = jax_kernel_draw[0]
    cand, ok = RS.sample_and_hit_reference(t(u4), float(R_SPHERE), t(center),
                                           RS.prep_faces(t(fvs1), t(fvs2)))
    inline = (LN.triangle_hits(t(fvs1), cand) > 0) & (LN.triangle_hits(t(fvs2), cand) > 0)
    np.testing.assert_array_equal(ok.numpy(), inline.numpy())


def test_sample_lines_geometry(scene):
    center = scene[4]
    key = jax.random.PRNGKey(2)
    u4 = np.asarray(jax.random.uniform(key, (4, 3000)))
    ref = np.asarray(JL.sample_lines(key, jnp.float32(R_SPHERE), jnp.asarray(center), 3000))
    got = LN.sample_lines(t(u4), float(R_SPHERE), t(center)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got[:, :3], axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("n", [100, 900])  # enough accepted / a shortfall
def test_fill_first_n_exact(jax_kernel_draw, n):
    _, cand_j, ok_j = jax_kernel_draw
    ref = np.asarray(JL._fill_first_n_gather(jnp.asarray(cand_j), jnp.asarray(ok_j), n))
    got = LN._fill_first_n_gather(t(cand_j), t(ok_j), n).numpy()
    np.testing.assert_array_equal(got, ref)
    if ok_j.sum() < n:
        assert (got[ok_j.sum():] == 0).all()


def test_resample_lines_keeps_first_accepted(scene):
    """resample_lines == the first n accepted of its own candidate stream,
    zero tail, deterministic in the uniforms."""
    v1, v2, _, _, center = scene
    n = 256
    g = torch.Generator().manual_seed(4)
    u4 = torch.rand((4, LN.ROUNDS * n), generator=g)
    out = LN.resample_lines(u4, float(R_SPHERE), t(center), n, t(v1), t(v2))
    fv = RS.prep_faces(G.bbox_face_vertices(t(v1)[None])[0],
                       G.bbox_face_vertices(t(v2)[None])[0])
    cand, ok = RS.sample_and_hit_reference(u4, float(R_SPHERE), t(center), fv)
    kept = cand[ok][:n].numpy()
    expect = np.zeros((n, 6), np.float32)
    expect[:len(kept)] = kept
    np.testing.assert_array_equal(out.numpy(), expect)
    np.testing.assert_array_equal(
        LN.resample_lines(u4, float(R_SPHERE), t(center), n, t(v1), t(v2)).numpy(),
        out.numpy())


def test_batched_plain_path_equals_per_sample_loop(scene):
    """sample_and_hit, the first-n fill and resample_lines with a leading
    batch axis equal B unbatched calls bit for bit."""
    v1, v2, _, _, center = scene
    B, n = 3, 120
    g = torch.Generator().manual_seed(6)
    u4 = torch.rand((B, 4, LN.ROUNDS * n), generator=g)
    shift = torch.tensor([[0.0, 0.0, 0.0], [0.05, -0.1, 0.02], [-0.2, 0.1, 0.1]])
    a = t(v1)[None] + shift[:, None]
    b = t(v2)[None] * torch.tensor([1.0, 0.9, 1.1])[:, None, None]
    r = torch.tensor([2.2, 1.9, 2.5])
    c = t(center)[None] + shift
    fv = RS.prep_faces(G.bbox_face_vertices(a), G.bbox_face_vertices(b))
    assert fv.shape == (B, 24, 16)
    cand, ok = RS.sample_and_hit(u4, r, c, fv)
    lines = LN.resample_lines(u4, r, c, n, a, b)
    assert cand.shape == (B, LN.ROUNDS * n, 6) and lines.shape == (B, n, 6)
    for s in range(B):
        fv_s = RS.prep_faces(G.bbox_face_vertices(a[s][None])[0],
                             G.bbox_face_vertices(b[s][None])[0])
        assert torch.equal(fv[s], fv_s)
        cand_s, ok_s = RS.sample_and_hit(u4[s], r[s], c[s], fv_s)
        assert torch.equal(cand[s], cand_s) and torch.equal(ok[s], ok_s)
        assert 0.02 < float(ok_s.float().mean()) < 0.98
        assert torch.equal(LN._fill_first_n_gather(cand, ok, n)[s],
                           LN._fill_first_n_gather(cand_s, ok_s, n))
        assert torch.equal(lines[s], LN.resample_lines(u4[s], r[s], c[s], n, a[s], b[s]))


def test_wrapper_refuses_other_devices(scene):
    _, _, fvs1, fvs2, center = scene
    u4 = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        RS.sample_and_hit(u4, 1.0, t(center).to("meta"),
                          RS.prep_faces(t(fvs1), t(fvs2)).to("meta"))
