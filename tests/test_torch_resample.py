"""The resampler's adversarial candidate sets (``ops/cuda/resample.py:
adversarial_cases``) through the port's plain version, against known
answers and the JAX package.

Bars: known answers exact (an axis-aligned line through the sphere's centre
hits both boxes, a line parallel to a face outside the box misses, q1 = q2
gives a zero direction at origin q1 + centre and no hit, a flat box gives
finite geometry); each mesh's labels exactly equal to the JAX XLA path's
``triangle_hits`` on identical candidates, on every case (no flip from
XLA:CPU's FMA contraction on these sets); a batched plain call equal to its
per-sample calls; the operation count of the kernel's design. The card-only
tests hold the kernel to this plain version on the same sets bit for bit
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import lines as JL
from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS

torch.set_num_threads(1)

N_POINTS = 40  # lattice points on the sphere: candidate i * 40 + j pairs points i and j


def _point(k, h):
    """The lattice index of azimuth k/8 and height index h (u = h/2 - 1)."""
    return k * 5 + h


def _run(case):
    u4, r, c, f1, f2 = RS.adversarial_cases()[case]
    fv = RS.prep_faces(f1, f2)
    cand, ok = RS.sample_and_hit(u4, r, c, fv)
    return cand, ok, fv, (f1, f2)


def test_axis_lines_through_the_centre_hit():
    cand, ok, _, _ = _run("cube")
    c = torch.tensor(RS.ADVERSARIAL_CENTER)
    # z: from the pole u = 1 to the pole u = -1; x: azimuth 0 to azimuth 1/2 at u = 0
    for q1, q2, d in (((0, 4), (0, 0), (0.0, 0.0, -1.0)), ((0, 2), (4, 2), (-1.0, 0.0, 0.0))):
        k = _point(*q1) * N_POINTS + _point(*q2)
        assert bool(ok[k])
        np.testing.assert_allclose(cand[k, :3].numpy(), d, rtol=0, atol=1e-7)
    z = _point(0, 4) * N_POINTS + _point(0, 0)
    assert torch.equal(cand[z], torch.cat([torch.tensor([0.0, 0.0, -1.0]),
                                           c + torch.tensor([0.0, 0.0, 1.0])]))


def test_line_parallel_to_a_face_outside_the_box_misses():
    """x = cx + sqrt(0.75) along -z: parallel to the four side faces of
    both cubes (denominator 1e-12 exactly) and outside both."""
    cand, ok, fv, _ = _run("cube")
    k = _point(0, 3) * N_POINTS + _point(0, 1)
    assert torch.equal(cand[k, :3], torch.tensor([0.0, 0.0, -1.0]))
    assert float(cand[k, 3]) > RS.ADVERSARIAL_CENTER[0] + 0.75
    assert not bool(ok[k])
    nh = fv[:, 9:12]
    side = (nh[:, 2] == 0)
    assert int(side.sum()) == 16  # 4 side faces x 2 triangles x 2 meshes
    denom = nh[side] @ cand[k, :3] + 1e-12
    assert bool((denom == torch.tensor(1e-12)).all())


def test_coincident_sphere_points_give_a_zero_direction():
    cand, ok, _, _ = _run("cube")
    c = torch.tensor(RS.ADVERSARIAL_CENTER)
    same = torch.arange(N_POINTS) * (N_POINTS + 1)
    assert bool((cand[same, :3] == 0).all())
    q = RS.sphere_points(RS.adversarial_cases()["cube"][0][0, same],
                         RS.adversarial_cases()["cube"][0][1, same], 1.0)
    assert torch.equal(cand[same, 3:], q + c)
    assert not bool(ok[same].any())


def test_flat_box_has_zero_area_faces_and_finite_geometry():
    cand, ok, fv, _ = _run("flat")
    S = fv[:, 12]
    assert int((S == 0).sum()) == 16  # the side faces of both meshes
    assert bool(torch.isfinite(cand).all()) and bool(torch.isfinite(fv).all())
    assert 0 < int(ok.sum()) < ok.numel()  # lines through the rectangle hit it


@pytest.mark.parametrize("case", [c for c in RS.ADVERSARIAL_CASES if not c.startswith("batch")])
def test_adversarial_labels_equal_jax_xla(case):
    """Each mesh's labels on the plain version's candidates equal the JAX
    XLA path's triangle_hits on the same candidates, candidate for
    candidate."""
    cand, ok, fv, fvs = _run(case)
    hits = []
    for m, f in enumerate(fvs):
        mine = RS._mesh_hit(fv[m * RS.NF:(m + 1) * RS.NF], cand)
        jax_hits = np.asarray(JL.triangle_hits(jnp.asarray(f.numpy()),
                                               jnp.asarray(cand.numpy()))) > 0
        np.testing.assert_array_equal(mine.numpy(), jax_hits)
        hits.append(mine)
    assert torch.equal(ok, hits[0] & hits[1])


def test_adversarial_batch_equals_its_samples():
    u4, r, c, f1, f2 = RS.adversarial_cases()["batch 6"]
    cand, ok = RS.sample_and_hit(u4, r, c, RS.prep_faces(f1, f2))
    for b, name in enumerate(RS.ADVERSARIAL_BOXES):
        one, ok_one, _, _ = _run(name)
        assert torch.equal(cand[b], one) and torch.equal(ok[b], ok_one)


def test_ops_needed_counts_the_second_mesh_for_its_hits_only():
    assert RS.ops_needed(10, 10) == 10 * RS.OPS_PER_CANDIDATE
    assert RS.ops_needed(10, 0) == 10 * (46 + RS.NF * 81)
    assert RS.ops_needed(200_000, 18_600) - RS.ops_needed(200_000, 18_599) == RS.NF * 81
