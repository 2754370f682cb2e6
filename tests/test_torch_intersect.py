"""The port's paired stage-1 sweep (ops/cuda/intersect.py) against the JAX
Pallas kernel in interpret mode (intersect_stage1_pair_lanemajor, small
tiles tl = tf = 128).

Bar: counts, slot indices and gathered slot coordinates EXACTLY equal, per
cloud, with the JAX outputs sliced to [:L] and empty slots masked by the
count. Both sides get the same neighbourhoods, lines and deltas.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import metric as JM
from a_robust_registration_loss_tpu.ops.pallas import intersect as JPK
from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
from torch_port_helpers import random_problem, t

torch.set_num_threads(1)
KMAX = 4


def _jax_pair(neis1, neis2, lines):
    """JAX lane-major pts-mode outputs -> per-cloud (count (2, L), slot_idx
    (2, L, kmax), slot_pts (2, L, kmax, 3, 3)) with empty slots zeroed, and
    the deltas both sides use."""
    d1 = JM.neighborhood_delta(jnp.asarray(neis1))
    d2 = JM.neighborhood_delta(jnp.asarray(neis2))
    count, idx, pts, _, Lp = JPK.intersect_stage1_pair_lanemajor(
        jnp.asarray(neis1), jnp.asarray(neis2), jnp.asarray(lines), d1, d2,
        kmax=KMAX, tl=128, tf=128, interpret=True)
    count, idx, pts = map(np.asarray, (count, idx, pts))
    L = lines.shape[0]
    c, i, p = [], [], []
    for cloud in range(2):
        lo = cloud * Lp
        cnt = count[0, lo:lo + L]
        filled = np.arange(KMAX)[None, :] < np.minimum(cnt, KMAX)[:, None]
        c.append(cnt)
        i.append(np.where(filled, idx[:, lo:lo + L].T, 0))
        p.append(np.where(filled[..., None, None],
                          pts[:, lo:lo + L].T.reshape(L, KMAX, 3, 3), 0.0))
    return (np.stack(c), np.stack(i), np.stack(p)), (np.asarray(d1), np.asarray(d2))


def _pts_pair(neis1, neis2, lines, d1, d2, plain=False, **kw):
    """Stage 1 of both clouds in pts mode -> (count, slot_idx, slot_pts)."""
    fn = IK.stage1_reference if plain else IK.stage1
    count, slot_idx, _, _, slot_pts = fn((neis1, neis2), lines, (d1, d2), emit_d2=False,
                                         emit_recon=False, emit_pts=True, **kw)
    return count, slot_idx, slot_pts


def _assert_equal(got, ref):
    for g, r, name in zip(got, ref, ("count", "slot_idx", "slot_pts")):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def test_plain_matches_pallas_ragged():
    """F = (333, 301), L = 257: ragged on both axes, clouds of unequal F."""
    neis1, neis2, lines = random_problem()
    ref, (d1, d2) = _jax_pair(neis1, neis2, lines)
    got = _pts_pair(t(neis1), t(neis2), t(lines), t(d1), t(d2))
    assert ref[0].sum() > 50  # a real test: the lines do hit
    _assert_equal(got, ref)


def test_counts_exceed_kmax_across_face_tiles():
    """One line hits 6 neighbourhoods of cloud 1 at faces straddling the
    128-face tile edges (count uncapped at 6, slots the first 4 in
    ascending order); cloud 2 has fewer faces (190) and one hit at 150."""
    rng = np.random.default_rng(0)

    def cloud(F, hit_faces):
        centers = rng.standard_normal((F, 3)).astype(np.float32)
        centers[:, 1] += 5.0  # far from the x-axis line
        for k, f in enumerate(hit_faces):
            centers[f] = [0.5 * k, 0.0, 0.0]
        # neighbours spread along the line: large spacing, tiny perpendicular
        spread = np.array([[0.0, 0.0, 0.0], [0.1, 0.001, 0.0],
                           [-0.1, 0.0, 0.001]], np.float32)
        return (centers[:, None, :] + spread[None]).reshape(F, 9)

    hit1 = [3, 126, 127, 128, 200, 310]
    neis1, neis2 = cloud(384, hit1), cloud(190, [150])
    lines = np.repeat(np.array([[1.0, 0.0, 0.0, -10.0, 0.0, 0.0]], np.float32),
                      129, axis=0)
    lines[1:, 4] = 50.0  # every other line misses everything
    ref, (d1, d2) = _jax_pair(neis1, neis2, lines)
    got = _pts_pair(t(neis1), t(neis2), t(lines), t(d1), t(d2))
    _assert_equal(got, ref)
    count, slot_idx, slot_pts = (x.numpy() for x in got)
    assert count[0, 0] == len(hit1) and count[1, 0] == 1
    np.testing.assert_array_equal(slot_idx[0, 0], hit1[:KMAX])
    np.testing.assert_array_equal(slot_pts[0, 0].reshape(KMAX, 9),
                                  neis1[hit1[:KMAX]])
    assert (count[:, 1:] == 0).all()


def test_line_chunking_is_invisible():
    neis1, neis2, lines = random_problem(seed=9, f1=150, f2=170, n_lines=200)
    args = (t(neis1), t(neis2), t(lines), M.neighborhood_delta(t(neis1)),
            M.neighborhood_delta(t(neis2)))
    a = _pts_pair(*args, plain=True, line_chunk=33)
    b = _pts_pair(*args, plain=True, line_chunk=1024)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_thresholds_match_pack_faces():
    d = np.random.default_rng(1).uniform(0.01, 0.3, 100).astype(np.float32)
    packed = np.asarray(JPK._pack_faces(jnp.zeros((100, 9), jnp.float32),
                                        jnp.asarray(d), 128))
    np.testing.assert_array_equal(IK.thresholds(t(d)).numpy(), packed[9, :100])


def test_wrapper_refuses_other_devices():
    x = torch.zeros((4, 9), device="meta")
    with pytest.raises(ValueError):
        _pts_pair(x, x, torch.zeros((3, 6), device="meta"), torch.zeros(4, device="meta"),
                  torch.zeros(4, device="meta"))
