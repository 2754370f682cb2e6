"""The resampler's round budget, ``ops/lines.py:resample_lines(...,
rounds, fast_rounds, u4_full)``, against the JAX package's ``lax.cond`` on
the CPU.

With ``fast_rounds < rounds`` the JAX function draws a fast stream from
``k_fast`` and falls back to a fresh stream from ``k_full`` when the fast
one keeps fewer than n lines (``jnp.sum(ok) >= n``); under ``vmap`` the
cond becomes a per-sample select. The port takes both streams' uniforms and
decides the branch on the device, sample by sample. Bars:

- on the port's own candidates, labelled by the JAX package's XLA
  ``triangle_hits`` (the barycentric test is a rounding knife edge, and
  XLA:CPU contracts multiply-adds), the branch and the lines equal JAX's
  ``lax.cond`` over ``_fill_first_n_gather`` bit for bit, at a radius where
  the fast stream suffices and one where it falls short;
- in a batch with one sample on each branch, each sample equals its
  unbatched call and JAX's selection;
- against JAX's own ``resample_lines`` on its own two draws: the same
  branch, the kept lines within 1e-4 and their count within 10% (the bars
  the JAX package holds its own resampler paths to);
- ``fast_rounds >= rounds`` is the one-stream call bit for bit;
- shapes that disagree with ``rounds``, ``fast_rounds`` or n raise;
- the plain candidate stage's ``skip`` zeroes exactly the skipped samples'
  labels;
- on ``chip_smoke.py``'s DCP pairs at the budget's tight radius
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
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
from torch_port_helpers import sphere_cloud, t

_spec = importlib.util.spec_from_file_location(
    "hit_test_labels", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools", "hit_test_labels.py"))
HIT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(HIT)

N, ROUNDS, FAST = 128, 10, 2
RADII = [1.3, 6.0]  # the fast stream suffices / falls short


def _clouds(seed):
    rng = np.random.default_rng(seed)
    v1 = sphere_cloud(200, rng, noise=0.02)
    v2 = sphere_cloud(200, rng, noise=0.02) + np.float32(0.05)
    return v1, v2


def _uniforms(seed, shape=()):
    """JAX's two draws of a budgeted call: (fast, full) as numpy."""
    k_fast, k_full = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.uniform(k_fast, (*shape, 4, FAST * N))),
            np.asarray(jax.random.uniform(k_full, (*shape, 4, ROUNDS * N))))


def _budget(u_fast, u_full, r, center, v1, v2):
    return LN.resample_lines(t(u_fast), r, t(center), N, t(v1), t(v2), rounds=ROUNDS,
                             fast_rounds=FAST, u4_full=t(u_full))


def _port_fill(u4, r, center, v1, v2):
    """The port's one-stream fill of u4's candidates."""
    return LN.resample_lines(t(u4), r, t(center), N, t(v1), t(v2),
                             rounds=u4.shape[-1] // N, fast_rounds=u4.shape[-1] // N)


def _fast_fill(streams):
    return JL._fill_first_n_gather(streams[0], streams[1], N)


def _full_fill(streams):
    return JL._fill_first_n_gather(streams[2], streams[3], N)


def _jax_cond(u_fast, u_full, r, center, v1, v2):
    """JAX's ``lax.cond`` replayed on the port's candidates: labelled by the
    XLA ``triangle_hits`` (op by op, as the JAX package runs it outside
    ``jit``), the branch ``jnp.sum(ok) >= n``, each branch filled by
    ``_fill_first_n_gather``. Returns (fast branch taken, lines)."""
    fvs = [JG.bbox_face_vertices(jnp.asarray(v)[None])[0] for v in (v1, v2)]
    # both streams labelled in one array: one shape for the op-by-op compiles
    cand = jnp.asarray(LN.sample_lines(t(np.concatenate([u_fast, u_full], -1)), r,
                                       t(center)).numpy())
    ok = (JL.triangle_hits(fvs[0], cand) > 0) & (JL.triangle_hits(fvs[1], cand) > 0)
    k = FAST * N
    enough = jnp.sum(ok[:k]) >= N
    lines = jax.lax.cond(enough, _fast_fill, _full_fill, (cand[:k], ok[:k], cand[k:], ok[k:]))
    return bool(enough), np.asarray(lines)


@pytest.mark.parametrize("radius", RADII)
def test_budget_is_the_jax_cond_on_the_port_candidates(radius):
    v1, v2 = _clouds(8)
    center = v2.mean(0)
    u_fast, u_full = _uniforms(int(radius * 10))
    got = _budget(u_fast, u_full, radius, center, v1, v2)
    fast, want = _jax_cond(u_fast, u_full, radius, center, v1, v2)
    assert fast == (radius == RADII[0])
    np.testing.assert_array_equal(got.numpy(), want)
    fills = [_port_fill(u, radius, center, v1, v2) for u in (u_fast, u_full)]
    assert not torch.equal(*fills)  # the branch shows in the lines
    assert torch.equal(got, fills[0 if fast else 1])


def test_budget_per_sample_in_a_batch_is_the_jax_cond():
    rng = np.random.default_rng(9)
    v1 = np.stack([sphere_cloud(200, rng, noise=0.02) for _ in range(2)])
    v2 = v1 + np.float32(0.05)
    radius = np.array(RADII, np.float32)
    center = v2.mean(1)
    u_fast, u_full = _uniforms(3, (2,))
    got = _budget(u_fast, u_full, t(radius), center, v1, v2)
    assert got.shape == (2, N, 6)
    for b in range(2):
        one = _budget(u_fast[b], u_full[b], t(radius[b]), center[b], v1[b], v2[b])
        assert torch.equal(got[b], one)
        fast, want = _jax_cond(u_fast[b], u_full[b], t(radius[b]), center[b], v1[b], v2[b])
        assert fast == (b == 0)
        np.testing.assert_array_equal(got[b].numpy(), want)


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
    """JAX's own ``resample_lines(key, ..., rounds=10, fast_rounds=2)`` under
    ``jit(vmap)``, as its trainers run it (``train/losses.py``), on one
    sample at each radius: (clouds, keys, lines (2, N, 6))."""
    v1, v2 = _clouds(11)
    keys = jnp.stack([jax.random.PRNGKey(100 + b) for b in range(2)])

    def one(key, r):
        return JL.resample_lines(key, r, jnp.asarray(v2.mean(0)), N, jnp.asarray(v1),
                                 jnp.asarray(v2), rounds=ROUNDS, fast_rounds=FAST)

    return (v1, v2), keys, np.asarray(jax.jit(jax.vmap(one))(keys, jnp.asarray(RADII)))


@pytest.mark.parametrize("b", [0, 1])  # the sample at RADII[b]
def test_budget_takes_the_branch_of_the_jax_resampler(jax_resampler, b):
    """JAX's own resampler on its own draws against the port on the same
    uniforms, held to the bars of the JAX package's own resampler paths:
    the same branch, each kept row within 1e-4 of the port's candidate at
    its place in that branch's stream, the kept count within 10%. The
    labels themselves are not compared: XLA:CPU contracts multiply-adds in
    the compiled program, which moves knife-edge labels (on sample 1's
    fallback stream, compiled alone, 16 of its 1,280 candidates against
    JAX's own op-by-op labels, which differ from the port's in 2), and a
    moved label shifts every later row, so the rows are matched by their
    index in the stream."""
    (v1, v2), keys, want = jax_resampler
    radius, center, want = RADII[b], v2.mean(0), want[b]
    u_streams = [np.asarray(jax.random.uniform(k, (4, rounds * N)))
                 for k, rounds in zip(jax.random.split(keys[b]), (FAST, ROUNDS))]
    fv = RS.prep_faces(G.bbox_face_vertices(t(v1)[None])[0], G.bbox_face_vertices(t(v2)[None])[0])
    streams = [[x.numpy() for x in RS.sample_and_hit(t(u), radius, t(center), fv)]
               for u in u_streams]
    jax_fast = _stream_index(want, streams[0][0]) is not None
    assert jax_fast == (b == 0)

    got = _budget(*u_streams, radius, center, v1, v2).numpy()
    cand, ok = streams[0 if jax_fast else 1]
    assert (int(streams[0][1].sum()) >= N) == jax_fast  # the port's branch
    idx_p = np.flatnonzero(ok)[:N]
    np.testing.assert_array_equal(got[:len(idx_p)], cand[idx_p])
    assert not got[len(idx_p):].any()
    idx_j = _stream_index(want, cand)
    assert idx_j is not None and abs(len(idx_p) - len(idx_j)) <= 0.1 * len(idx_j)


@pytest.mark.parametrize("fast_rounds", [ROUNDS, ROUNDS + 2])
def test_no_budget_is_the_one_stream_call(fast_rounds):
    v1, v2 = _clouds(8)
    center = v2.mean(0)
    u4 = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (2, 4, ROUNDS * N)))
    radius = t(np.array(RADII, np.float32))
    c, a, b = (t(np.stack([x, x])) for x in (center, v1, v2))
    today = LN.resample_lines(t(u4), radius, c, N, a, b)
    got = LN.resample_lines(t(u4), radius, c, N, a, b, rounds=ROUNDS, fast_rounds=fast_rounds)
    assert torch.equal(got, today)
    cand, ok = RS.sample_and_hit(t(u4), radius, c, RS.prep_faces(G.bbox_face_vertices(a),
                                                                 G.bbox_face_vertices(b)))
    assert torch.equal(today, LN._fill_first_n_gather(cand, ok, N))


@pytest.mark.parametrize("case", ["u4 not rounds * n", "u4 not fast_rounds * n",
                                  "no fallback stream", "fallback not rounds * n",
                                  "fallback batch differs", "fallback without a budget"])
def test_mismatched_shapes_raise(case):
    v1, v2 = (t(v) for v in _clouds(8))
    c = v2.mean(0)
    fast, full = torch.rand(4, FAST * N), torch.rand(4, ROUNDS * N)
    call = dict(rounds=ROUNDS, fast_rounds=FAST, u4_full=full)
    u4 = fast
    if case == "u4 not rounds * n":
        u4, call = full[:, :-1], {}
    elif case == "u4 not fast_rounds * n":
        u4 = torch.rand(4, FAST * N + 1)
    elif case == "no fallback stream":
        call["u4_full"] = None
    elif case == "fallback not rounds * n":
        call["u4_full"] = full[:, :-N]
    elif case == "fallback batch differs":
        call["u4_full"] = full[None]
    else:
        u4, call = full, dict(u4_full=full)
    with pytest.raises(ValueError):
        LN.resample_lines(u4, 1.3, c, N, v1, v2, **call)


@pytest.mark.parametrize("batched", [False, True])
def test_plain_skip_zeroes_exactly_the_skipped_samples(batched):
    v1, v2 = _clouds(8)
    fv = RS.prep_faces(G.bbox_face_vertices(t(v1)[None])[0], G.bbox_face_vertices(t(v2)[None])[0])
    u4, r, c = torch.rand(4, 300, generator=torch.Generator().manual_seed(1)), 1.3, t(v2.mean(0))
    skips = [torch.tensor(True), torch.tensor(False)]
    if batched:
        u4, fv, c = u4.expand(3, 4, 300), fv.expand(3, 24, 16), c.expand(3, 3)
        r = torch.full((3,), 1.3)
        skips = [torch.tensor([True, False, True]), torch.tensor([False] * 3),
                 torch.tensor([True] * 3)]
    cand, ok = RS.sample_and_hit(u4, r, c, fv)
    assert ok.any(-1).all()
    for skip in skips:
        cand_s, ok_s = RS.sample_and_hit(u4, r, c, fv, skip=skip)
        assert torch.equal(cand_s, cand)
        assert not ok_s[skip].any()
        assert torch.equal(ok_s[~skip], ok[~skip])


@pytest.mark.parametrize("pair", [0, 1])
def test_tight_radius_labels_are_jax_on_dcp_pairs(pair):
    """The budget phase's DCP pairs at its tight radius, taken apart by
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
