"""The port's stage-1 API in every output mode (ops/cuda/intersect.py:
intersect_stage1, intersect_stage1_pair) against the JAX Pallas kernel in
interpret mode (PK.intersect_stage1 / PK.intersect_stage1_pair, small tiles
tl = tf = 128), on the CPU, where the wrappers run their plain versions.

Bars: count, slot_idx (2**30 on empty slots) and slot_pts exactly equal.
slot_d2 within 1e-6 times |p - x0|^2, and slot_recon within 5e-4 absolute,
with its recipe held within 1e-6: XLA:CPU contracts the kernel's
multiply-adds into FMAs and the port rounds every operation on its own, so
d2 = |p - x0|^2 - proj^2, a difference of two numbers near 16 here, carries
a few ulps of |p - x0|^2 on either side (both within 3.3e-6 of the float64
value; the largest port-JAX difference seen over five seeds was 4.9e-7 times
|p - x0|^2, 3.2e-6 absolute). The split and merge the CUDA kernel makes
(``stage1_reference(..., segments=S)``: S face segments swept on their own,
merged per line in segment order) equals the unsplit plain version exactly,
for S in {1, 2, 4, 7} and every mode. The recon weights d_i = sqrt(d2_i + 2e-4)
magnify that to at most 4.9e-5 absolute seen (a d2 change of 3e-6 moves a
weight by up to 7.5e-3 relative, times the neighbourhood spread). The
port's recon arithmetic applied to JAX's own slot_d2 gives JAX's slot_recon
within 1.2e-7. A batched call equals B single calls bit for bit.
"""

import itertools
import os
import re

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
MODES = list(itertools.product((False, True), repeat=3))  # (d2, recon, pts)
NAMES = ("count", "slot_idx", "slot_d2", "slot_recon", "slot_pts")


@pytest.fixture(scope="module")
def ragged():
    """F = (333, 301), L = 257: ragged on both axes, clouds of unequal F."""
    return random_problem(seed=7, f1=333, f2=301, n_lines=257)


def _deltas(*neis):
    return [np.asarray(JM.neighborhood_delta(jnp.asarray(n))) for n in neis]


def _assert_match(got, ref, flags, neis, lines):
    """One cloud's tuple against JAX's: None exactly where a mode is off,
    integers and coordinates exact, d2 and recon within the bars above."""
    idx = np.asarray(ref[1])
    P = neis[np.minimum(idx, neis.shape[0] - 1)].reshape(idx.shape + (3, 3))
    d_ac = ((P.astype(np.float64) - lines[:, None, None, 3:]) ** 2).sum(-1)
    for name, on, g, r in zip(NAMES, (True, True, *flags), got, ref):
        if not on:
            assert g is None and r is None, name
            continue
        r = np.asarray(r)
        if name == "slot_d2":
            assert (np.abs(g.numpy() - r) <= 1e-6 * d_ac).all(), name
        elif name == "slot_recon":
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=5e-4, err_msg=name)
            if ref[2] is not None and ref[4] is not None:  # the recipe on JAX's d2
                np.testing.assert_allclose(
                    IK._slot_recon(t(ref[4]), t(ref[2])).numpy(), r, rtol=0,
                    atol=1e-6, err_msg="recon recipe")
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


@pytest.mark.parametrize("clouds", ["single", "pair"])
@pytest.mark.parametrize("flags", MODES, ids=lambda f: "d2%d-recon%d-pts%d" % f)
def test_modes_match_pallas(ragged, clouds, flags):
    neis1, neis2, lines = ragged
    d1, d2 = _deltas(neis1, neis2)
    kw = dict(emit_d2=flags[0], emit_recon=flags[1], emit_pts=flags[2])
    if clouds == "single":
        ref = [JPK.intersect_stage1(jnp.asarray(neis1), jnp.asarray(lines),
                                    jnp.asarray(d1), tl=128, tf=128,
                                    interpret=True, **kw)]
        got = [IK.intersect_stage1(t(neis1), t(lines), t(d1), **kw)]
    else:
        ref = JPK.intersect_stage1_pair(
            jnp.asarray(neis1), jnp.asarray(neis2), jnp.asarray(lines),
            jnp.asarray(d1), jnp.asarray(d2), tl=128, tf=128, interpret=True, **kw)
        got = IK.intersect_stage1_pair(t(neis1), t(neis2), t(lines), t(d1), t(d2), **kw)
    assert int(got[0][0].sum()) > 50  # a real test: the lines do hit
    for g, r, n in zip(got, ref, (neis1, neis2)):
        _assert_match(g, r, flags, n, lines)


def test_pair_unequal_cloud_sizes():
    """F1 != F2 (333, 190), every mode on: the pair equals JAX's pair and
    each cloud equals its own single-cloud call."""
    neis1, neis2, lines = random_problem(seed=37, f1=333, f2=190)
    d1, d2 = _deltas(neis1, neis2)
    ref = JPK.intersect_stage1_pair(
        jnp.asarray(neis1), jnp.asarray(neis2), jnp.asarray(lines),
        jnp.asarray(d1), jnp.asarray(d2), tl=128, tf=128, emit_d2=True,
        emit_recon=True, emit_pts=True, interpret=True)
    kw = dict(emit_d2=True, emit_recon=True, emit_pts=True)
    got = IK.intersect_stage1_pair(t(neis1), t(neis2), t(lines), t(d1), t(d2), **kw)
    for g, r, n in zip(got, ref, (neis1, neis2)):
        _assert_match(g, r, (True, True, True), n, lines)
    for g, n, d in zip(got, (neis1, neis2), (d1, d2)):
        single = IK.intersect_stage1(t(n), t(lines), t(d), **kw)
        for a, b in zip(g, single):
            assert torch.equal(a, b)


@pytest.mark.parametrize("clouds", ["single", "pair"])
def test_batch_equals_single_calls(clouds):
    """A (B, ...) call equals B unbatched calls bit for bit, every mode on,
    with samples of one F but different clouds and lines."""
    probs = [random_problem(seed=s, f1=150, f2=150, n_lines=130) for s in (1, 2, 3)]
    neis1, neis2, lines = (torch.stack([t(p[k]) for p in probs]) for k in range(3))
    d1, d2 = M.neighborhood_delta(neis1), M.neighborhood_delta(neis2)
    kw = dict(emit_d2=True, emit_recon=True, emit_pts=True)
    if clouds == "single":
        got = [IK.intersect_stage1(neis1, lines, d1, **kw)]
        per = [[IK.intersect_stage1(neis1[b], lines[b], d1[b], **kw)] for b in range(3)]
    else:
        got = IK.intersect_stage1_pair(neis1, neis2, lines, d1, d2, **kw)
        per = [IK.intersect_stage1_pair(neis1[b], neis2[b], lines[b], d1[b], d2[b], **kw)
               for b in range(3)]
    for cloud, g in enumerate(got):
        assert g[0].shape == (3, 130)
        for name, x in zip(NAMES, g):
            ref = torch.stack([per[b][cloud][NAMES.index(name)] for b in range(3)])
            assert torch.equal(x, ref), name


def test_raw_layout_and_pts_entry(ragged):
    """``stage1`` keeps 0 on empty slots and a cloud axis; in pts mode alone
    it gives the same count, slots and coordinates."""
    neis1, neis2, lines = ragged
    args = (t(neis1), t(neis2), t(lines), M.neighborhood_delta(t(neis1)),
            M.neighborhood_delta(t(neis2)))
    raw = IK.stage1(args[:2], args[2], args[3:], emit_d2=True, emit_recon=False,
                    emit_pts=True)
    assert raw[0].shape == (2, 257) and raw[3] is None
    pair = IK.intersect_stage1_pair(*args, emit_d2=True, emit_recon=False, emit_pts=True)
    for cloud in range(2):
        filled = pair[cloud][1] != IK.EMPTY
        assert torch.equal(torch.where(filled, pair[cloud][1], 0), raw[1][cloud])
        assert torch.equal(pair[cloud][2], raw[2][cloud])
    pts = IK.stage1(args[:2], args[2], args[3:], emit_d2=False, emit_recon=False,
                    emit_pts=True)
    assert pts[2] is None and pts[3] is None
    for a, b in zip((pts[0], pts[1], pts[4]), (raw[0], raw[1], raw[4])):
        assert torch.equal(a, b)


def test_recon_mode_takes_the_reciprocal():
    """The recon plain version forms 1 / sum d once and multiplies: on
    hand-made d2 it equals that recipe in numpy float32 bit for bit, and
    the glue's division within an ulp-sized tolerance."""
    rng = np.random.default_rng(3)
    P = rng.standard_normal((50, 4, 3, 3)).astype(np.float32)
    d2 = rng.uniform(-1e-4, 0.05, (50, 4, 3)).astype(np.float32)
    got = IK._slot_recon(t(P), t(d2)).numpy()
    d = np.sqrt(np.maximum(d2 + np.float32(2e-4), np.float32(0)))
    dinv = np.float32(1) / (d[..., 0] + d[..., 1] + d[..., 2])
    want = np.float32(0) + (d[..., 0] * dinv)[..., None] * P[..., 0, :]
    for i in (1, 2):
        want = want + (d[..., i] * dinv)[..., None] * P[..., i, :]
    np.testing.assert_array_equal(got, want)
    glue = ((d / d.sum(-1, keepdims=True))[..., None] * P).sum(-2)
    np.testing.assert_allclose(got, glue, rtol=0, atol=1e-6)


def _dense_first_faces(neis, lines, copies=6):
    """The first ``copies`` faces become one equilateral triangle of side
    0.2 and every line passes through its centroid, so every line hits all
    of them: the first segment alone overflows kmax slots."""
    c = np.array([0.3, -0.2, 0.6], np.float32)
    tri = c + np.float32(0.2 / 3**0.5) * np.array(
        [[1.0, 0.0, 0.0], [-0.5, 0.75**0.5, 0.0], [-0.5, -(0.75**0.5), 0.0]], np.float32)
    neis, lines = neis.copy(), lines.copy()
    neis[:copies] = tri.reshape(9)
    lines[:, 3:] = c
    return neis, lines


def _assert_split_equals_unsplit(neis, lines, segments, kmax, flags):
    neis = [t(n) for n in neis]
    deltas = [M.neighborhood_delta(n) for n in neis]
    kw = dict(emit_d2=flags[0], emit_recon=flags[1], emit_pts=flags[2])
    ref = IK.stage1_reference(neis, t(lines), deltas, kmax, **kw)
    got = IK.stage1_reference(neis, t(lines), deltas, kmax, segments=segments, **kw)
    for name, on, g, r in zip(NAMES, (True, True, *flags), got, ref):
        assert (g is None) == (not on) == (r is None), name
        if on:
            assert torch.equal(g, r), name
    return ref


@pytest.mark.parametrize("segments", [1, 2, 4, 7])
@pytest.mark.parametrize("flags", MODES, ids=lambda f: "d2%d-recon%d-pts%d" % f)
def test_segment_merge_equals_unsplit(ragged, segments, flags):
    neis1, neis2, lines = ragged
    ref = _assert_split_equals_unsplit((neis1, neis2), lines, segments, IK.KMAX, flags)
    assert int(ref[0].sum()) > 50 and int(ref[0].max()) > IK.KMAX  # slots overflow too


@pytest.mark.parametrize("segments", [1, 2, 4, 7])
@pytest.mark.parametrize("case", ["kmax1", "few-faces", "dense-first-segment", "one-cloud"])
def test_segment_merge_edge_cases(ragged, segments, case):
    neis1, neis2, lines = ragged
    kmax, neis = IK.KMAX, (neis1, neis2)
    if case == "kmax1":
        kmax = 1
    elif case == "few-faces":  # fewer faces than segments: some segments are empty
        neis = (neis1[:3], neis2[:2])
    elif case == "dense-first-segment":
        dense, lines = _dense_first_faces(neis1, lines)
        neis = (dense, neis2)
    else:
        neis = (neis1,)
    ref = _assert_split_equals_unsplit(neis, lines, segments, kmax, (True, True, True))
    if case == "dense-first-segment":
        assert IK.segment_length(neis1.shape[0], segments) >= 6
        assert int(ref[0][0].min()) > kmax


@pytest.mark.parametrize("n_faces,segments,want", [
    (2048, 4, 512), (2048, 1, 2048), (1024, 2, 512), (333, 4, 128), (333, 2, 256),
    (333, 1, 512), (3, 4, 64), (0, 4, 0), (1000, 4, 256)])
def test_segment_length_is_whole_steps(n_faces, segments, want):
    """Segments are whole steps of STEP_FACES / S faces and cover the cloud."""
    n = IK.segment_length(n_faces, segments)
    assert n == want and n % (IK.STEP_FACES // segments) == 0 and n * segments >= n_faces


def test_segment_constants_mirror_the_kernel_source():
    """SEGMENTS and STEP_FACES are the kernel's: a warp of the block's
    kThreads per segment, kStepFaces faces a step."""
    with open(os.path.join(os.path.dirname(IK.__file__), "..", "..", "csrc", "intersect.cu")) as f:
        src = f.read()
    const = {k: v for k, v in re.findall(r"constexpr int (\w+) = ([^;]+);", src)}
    assert const["kSegments"] == "kWarps" and const["kWarps"] == "kThreads / 32"
    assert int(const["kThreads"]) // 32 == IK.SEGMENTS
    assert int(const["kStepFaces"]) == IK.STEP_FACES


def test_reference_refuses_no_segments(ragged):
    neis1, _, lines = ragged
    with pytest.raises(ValueError):
        IK.stage1_reference((t(neis1),), t(lines), (M.neighborhood_delta(t(neis1)),), segments=0)
