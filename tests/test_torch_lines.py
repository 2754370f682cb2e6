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

``resample_lines`` itself, one stream of ``ROUNDS * n`` candidates as the
JAX package draws it: on the port's candidates labelled by the JAX XLA
``triangle_hits``, its lines equal JAX's ``_fill_first_n_gather`` bit for
bit; against JAX's own ``resample_lines`` under ``jit(vmap)`` on the same
uniforms, its kept rows meet the bars above (rows within 1e-4, the kept
count within 10%). On ``chip_smoke.py``'s DCP pairs at a tight radius
(``tools/hit_test_labels.py``), the port's labels are the JAX package's
``triangle_hits``, mesh by mesh.
"""

import importlib.util
import os

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

_spec = importlib.util.spec_from_file_location(
    "hit_test_labels", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools", "hit_test_labels.py"))
HIT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(HIT)

torch.set_num_threads(1)

R_SPHERE = np.float32(2.2)
N_STREAM = 128  # lines of the one-stream tests, from LN.ROUNDS * N_STREAM candidates
RADII = [1.3, 6.0]  # most candidates kept / too few to fill the n lines


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


def _clouds(seed):
    rng = np.random.default_rng(seed)
    v1 = sphere_cloud(200, rng, noise=0.02)
    v2 = sphere_cloud(200, rng, noise=0.02) + np.float32(0.05)
    return v1, v2


def _stream_case(radius, batched):
    """(u4, r, center, v1, v2) as numpy: one sample, or a batch of two
    samples with different clouds, at ``radius``; the uniforms are a
    ``jax.random`` draw of LN.ROUNDS * N_STREAM candidates."""
    if batched:
        rng = np.random.default_rng(9)
        v1 = np.stack([sphere_cloud(200, rng, noise=0.02) for _ in range(2)])
        v2 = v1 + np.float32(0.05)
        key, lead = jax.random.PRNGKey(3), (2,)
    else:
        v1, v2 = _clouds(8)
        key, lead = jax.random.PRNGKey(int(radius * 10)), ()
    u4 = np.asarray(jax.random.uniform(jax.random.split(key)[1],
                                       (*lead, 4, LN.ROUNDS * N_STREAM)))
    return u4, np.full(lead, radius, np.float32), v2.mean(-2), v1, v2


def _jax_fill(u4, r, center, v1, v2):
    """JAX's fill of the port's candidates: labelled by the XLA
    ``triangle_hits`` (op by op, as the JAX package runs it outside
    ``jit``), then ``_fill_first_n_gather``."""
    fvs = [JG.bbox_face_vertices(jnp.asarray(v)[None])[0] for v in (v1, v2)]
    cand = jnp.asarray(LN.sample_lines(t(u4), t(r), t(center)).numpy())
    ok = (JL.triangle_hits(fvs[0], cand) > 0) & (JL.triangle_hits(fvs[1], cand) > 0)
    return np.asarray(JL._fill_first_n_gather(cand, ok, N_STREAM))


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("radius", RADII)
def test_resample_lines_is_the_jax_fill_on_the_port_candidates(radius, batched):
    u4, r, center, v1, v2 = _stream_case(radius, batched)
    got = LN.resample_lines(t(u4), t(r), t(center), N_STREAM, t(v1), t(v2)).numpy()
    assert got.shape == u4.shape[:-2] + (N_STREAM, 6)
    for b in np.ndindex(u4.shape[:-2]):
        np.testing.assert_array_equal(got[b], _jax_fill(u4[b], r[b], center[b], v1[b], v2[b]))
    kept = (np.abs(got).sum(-1) > 0).sum(-1)
    assert np.all(kept == N_STREAM) if radius == RADII[0] else np.all(kept < N_STREAM)


def _stream_index(lines, cand):
    """The stream index of each kept (nonzero) row of ``lines``, the kept
    rows being candidates in stream order: each row matched to the next
    candidate within 1e-4; None if one has no match."""
    idx, i = [], 0
    for row in lines[np.abs(lines).sum(-1) > 0]:
        while i < len(cand) and np.abs(cand[i] - row).max() > 1e-4:
            i += 1
        if i == len(cand):
            return None
        idx.append(i)
        i += 1
    return np.array(idx)


@pytest.fixture(scope="module")
def jax_resampler():
    """JAX's own one-stream ``resample_lines`` under ``jit(vmap)``, as its
    trainers run it (``train/losses.py``), on two samples with different
    clouds at each radius: {radius: (keys, clouds (v1, v2) (2, N, 3), lines
    (2, n, 6))}."""
    rng = np.random.default_rng(11)
    v1 = np.stack([sphere_cloud(200, rng, noise=0.02) for _ in range(2)])
    v2 = v1 + np.float32(0.05)
    keys = jnp.stack([jax.random.PRNGKey(100 + b) for b in range(2)])

    def one(key, r, a, b):
        return JL.resample_lines(key, r, jnp.mean(b, 0), N_STREAM, a, b)

    run = jax.jit(jax.vmap(one, in_axes=(0, None, 0, 0)))
    return {r: (keys, (v1, v2), np.asarray(run(keys, jnp.float32(r), jnp.asarray(v1),
                                                jnp.asarray(v2))))
            for r in RADII}


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("radius", RADII)
def test_resample_lines_meets_the_jax_resampler_bars(jax_resampler, radius, batched):
    """JAX's own resampler on its own keys against the port on the same
    uniforms, held to the bars of the JAX package's own resampler paths:
    each kept row within 1e-4 of the port's candidate at its place in the
    stream, the kept count within 10%. The labels themselves are not
    compared: XLA:CPU contracts multiply-adds in the compiled program,
    which moves knife-edge labels, and a moved label shifts every later
    row, so the rows are matched by their index in the stream."""
    keys, (v1, v2), want = jax_resampler[radius]
    u4 = np.stack([np.asarray(jax.random.uniform(k, (4, LN.ROUNDS * N_STREAM))) for k in keys])
    center = v2.mean(1)
    if batched:
        got = LN.resample_lines(t(u4), t(np.full(2, radius, np.float32)), t(center), N_STREAM,
                                t(v1), t(v2)).numpy()
    else:
        got = np.stack([LN.resample_lines(t(u4[b]), radius, t(center[b]), N_STREAM, t(v1[b]),
                                          t(v2[b])).numpy() for b in range(2)])
    for b in range(2):
        fv = RS.prep_faces(G.bbox_face_vertices(t(v1[b])[None])[0],
                           G.bbox_face_vertices(t(v2[b])[None])[0])
        cand, ok = (x.numpy() for x in RS.sample_and_hit(t(u4[b]), radius, t(center[b]), fv))
        idx_p = np.flatnonzero(ok)[:N_STREAM]
        np.testing.assert_array_equal(got[b, :len(idx_p)], cand[idx_p])
        assert not got[b, len(idx_p):].any()
        idx_j = _stream_index(want[b], cand)
        assert idx_j is not None and abs(len(idx_p) - len(idx_j)) <= 0.1 * len(idx_j)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("width", ["one candidate short", "one round too many"])
def test_resample_lines_refuses_a_u4_of_another_width(width, batched):
    v1, v2 = (t(v) for v in _clouds(8))
    c, r = v2.mean(0), torch.tensor(RADII[0])
    C = LN.ROUNDS * N_STREAM - 1 if width == "one candidate short" else (LN.ROUNDS + 1) * N_STREAM
    u4 = torch.rand(4, C)
    if batched:
        u4, r, c, v1, v2 = (x.expand(2, *x.shape) for x in (u4, r, c, v1, v2))
    with pytest.raises(ValueError, match="candidates"):
        LN.resample_lines(u4, r, c, N_STREAM, v1, v2)


@pytest.mark.parametrize("pair", [0, 1])
def test_tight_radius_labels_are_jax_on_dcp_pairs(pair):
    """``chip_smoke.py``'s DCP pairs at a tight radius, taken apart by
    ``tools/hit_test_labels.py``: the sphere lies inside both boxes, so
    every line crosses each box's surface twice; the port labels every
    candidate as the JAX package's ``triangle_hits`` does, mesh by mesh; and
    the float32 test passes no line that misses a face. (Pair 1's target box
    passes few of its crossings: the A + B + C <= S knife edge of both
    packages.)"""
    rec = HIT.labels(pair, candidates=2000, with_jax=True)
    np.testing.assert_array_equal(rec["port_hits"], rec["jax_hits"])
    for mesh in ("mesh1", "mesh2"):
        assert rec[mesh]["margin"] > 1
        faces = rec[mesh]["faces"]
        assert sum(f["crossing"] for f in faces) == 2 * 2000
        assert not any(f["passed_not_crossing"] for f in faces)
