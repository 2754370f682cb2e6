"""The port's (dp, sp) mesh (parallel/mesh.py), its sharded line glue and
line-parallel metric (train/losses.py), and the resampler every rank
replicates (ops/lines.py), on the CPU.

Two worlds of gloo ranks (``torch_parallel_ranks.py``, which imports no
JAX): one of 2 ranks under (1, 2) and (2, 1), one of 4 under every
factorisation. Bars:

- ``make_mesh`` places rank r at (r // sp, r % sp) with its sp row's and dp
  column's groups; ``shard_batch`` keeps the dp rows of a leaf whose
  leading axis divides by dp and leaves the others whole; a shape that is
  not the world's, and lines that do not divide by sp, raise;
- ``gather_lines``' backward is this rank's slice of the cotangent, where
  ``torch.distributed.nn.functional.all_gather`` returns sp times it;
- ``batch_lines`` under every mesh: each rank's lines are the single
  process's rows and line shard bit for bit;
- ``_metric_batch_rt_sp``: values equal to the unsharded port's, gradient
  in R and t within 1e-5 relative L2; against the JAX package's
  ``_metric_batch_rt`` on the same lines, values within 2e-5 and gradients
  within 5e-3 (``TestSpParallelPallas``' bars; the port reaches the
  figures the test prints);
- ``dcp_cal_loss`` under a mesh against the JAX ``dcp_cal_loss`` on the same
  lines, 1e-5 relative (``test_sharded_loss_matches_unsharded``'s bar): the
  loss and every monitor, each the mean over the dp ranks; the two
  root-mean-square monitors are the global batch's on every rank;
- one step of the batched classical objective (the port's counterpart of
  the JAX package's ``dryrun_multichip``) under (1, 4), (2, 2) and (4, 1):
  the mean loss and the new twists equal the single process's within
  1e-6;
- ``resample_lines``, unbatched and per sample in a batch, equal to the
  first n lines of its candidates as the JAX package's XLA
  ``triangle_hits`` labels them and its sort-based ``_fill_first_n`` keeps
  them; ``_fill_first_n_gather`` equal to that fill.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import geometry as JG
from a_robust_registration_loss_tpu.ops import lines as JL
from a_robust_registration_loss_tpu.train import losses as JLS
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.parallel import mesh as PM
from a_robust_registration_loss_tpu_torch.train import losses as LS
import torch_parallel_ranks as TR
from torch_port_helpers import make_batch, sphere_cloud, t

torch.set_num_threads(1)
DCP_LINES = 256
SHAPES4 = [(1, 4), (2, 2), (4, 1)]


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def prob():
    return TR.problem(B=4)


@pytest.fixture(scope="module")
def dcp_inputs():
    """A DCP batch of 2, predicted transforms near its ground truth, the
    global batch's uniforms and the lines one process draws from them."""
    batch = make_batch(B=2, N=48, F=24, seed=3)
    rng = np.random.default_rng(4)
    turn = [np.linalg.qr(np.eye(3) + 0.02 * rng.standard_normal((3, 3)))[0] for _ in range(2)]
    R_ab = np.stack([R @ (q * np.sign(np.diag(q))) for R, q in zip(batch["R"], turn)])
    R_ab = R_ab.astype(np.float32)
    t_ab = (batch["T"] + 0.01 * rng.standard_normal((2, 3))).astype(np.float32)
    u4 = rng.random((2, 4, LN.ROUNDS * DCP_LINES), dtype=np.float32)
    src = t(batch["points_src_sample"])
    pred = LS.dcp_transform(src, t(R_ab), t(t_ab))
    lines = LS.batch_lines(t(u4), t(batch["tar_box"]), t(batch["centers"]), DCP_LINES, pred,
                           t(batch["points_tar_sample"]), 0.5)
    return batch, R_ab, t_ab, u4, lines.numpy()


@pytest.fixture(scope="module")
def world2(prob, dcp_inputs, tmp_path_factory):
    batch, R_ab, t_ab, u4, _ = dcp_inputs
    return TR.launch(TR.basics2, 1, 2, tmp_path_factory.mktemp("world2"),
                     args=(prob, batch, R_ab, t_ab, u4, DCP_LINES))


@pytest.fixture(scope="module")
def world4(prob, tmp_path_factory):
    return TR.launch(TR.basics4, 2, 2, tmp_path_factory.mktemp("world4"), args=(prob,))


@pytest.mark.parametrize("shape", SHAPES4)
def test_make_mesh_places_ranks_and_groups(world4, shape):
    dp, sp = shape
    rows = torch.arange(8).reshape(4, 2)
    for r, out in enumerate(world4):
        got = out[shape]
        i, j = divmod(r, sp)
        assert got["place"] == (r, i, j)
        assert got["sp_members"] == [i * sp + k for k in range(sp)]
        assert got["dp_members"] == [k * sp + j for k in range(dp)]
        n = 4 // dp
        assert torch.equal(got["shard"]["rows"], rows[i * n:(i + 1) * n])
        assert torch.equal(got["shard"]["odd"], torch.arange(3))  # 3 rows: whole
        assert float(got["shard"]["scalar"]) == 5.0


def test_make_mesh_errors(world2):
    for out in world2:
        assert "dp*sp == 3 != 2" in out[(3, 1)] and "dp*sp == 4 != 2" in out[(2, 2)]
        assert "7 lines do not divide by sp = 2" in out["odd_lines"]
    with pytest.raises(RuntimeError, match="not initialised"):
        PM.make_mesh(1, 1)


def test_gather_lines_backward_is_own_slice(world2):
    for r, out in enumerate(world2):
        g = out["gather"]
        x = [torch.arange(12.0).reshape(2, 3, 2) + 100 * k for k in range(2)]
        assert torch.equal(g["y"], torch.cat(x, 1))
        own = g["w"][:, 3 * r:3 * r + 3]
        assert torch.equal(g["ours"], own)
        assert torch.equal(g["theirs"], 2 * own)  # the sum over the sp members


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (4, 1)])
def test_batch_lines_bitwise_under_every_mesh(prob, world2, world4, shape):
    single = torch.tensor(prob["lines"])
    if shape == (1, 1):  # one process: the per-sample resampler's lines
        box = t(prob["tar_box"])
        r = 0.5 * torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
        for b in range(single.shape[0]):
            one = LN.resample_lines(t(prob["u4"][b]), r[b], t(prob["centers"][b]),
                                    single.shape[1], t(prob["src"][b]), t(prob["tar"][b]))
            assert torch.equal(single[b], one)
        return
    dp, sp = shape
    world = world2 if dp * sp == 2 else world4
    n, L = single.shape[0] // dp, single.shape[1] // sp
    for r, out in enumerate(world):
        i, j = divmod(r, sp)
        got = out[shape]["lines"]
        assert torch.equal(got, single[i * n:(i + 1) * n, j * L:(j + 1) * L])


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_metric_sp_matches_unsharded(prob, world2, shape):
    v, dR, dt = TR.metric_rt(prob)
    dp, sp = shape
    n = v.shape[0] // dp
    for r, out in enumerate(world2):
        i = r // sp
        gv, gR, gt = out[shape]["metric"]
        assert torch.equal(gv, v[i * n:(i + 1) * n])
        assert _rel_l2(gR, dR[i * n:(i + 1) * n]) <= 1e-5
        assert _rel_l2(gt, dt[i * n:(i + 1) * n]) <= 1e-5


def test_metric_sp_matches_jax(prob, world2):
    cfg = JLS.LossConfig(line_chunk=None)

    def total(R, tt):
        vals = JLS._metric_batch_rt(R, tt, jnp.asarray(prob["n1"]), jnp.asarray(prob["n2"]),
                                    jnp.asarray(prob["lines"]), cfg)
        return jnp.sum(vals), vals

    # op by op: under jit XLA:CPU contracts multiply-adds into FMAs (ROADMAP.md
    # Queue 3, handled), which moves the values by up to 3e-5 here
    (_, v), (dR, dt) = jax.value_and_grad(total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(prob["R"]), jnp.asarray(prob["t"]))
    for out in world2:
        gv, gR, gt = out[(1, 2)]["metric"]
        np.testing.assert_allclose(gv.numpy(), np.asarray(v), rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(gR.numpy(), np.asarray(dR), rtol=5e-3, atol=1e-6)
        np.testing.assert_allclose(gt.numpy(), np.asarray(dt), rtol=5e-3, atol=1e-6)
    print(f"sp metric against JAX: values {_rel_l2(gv, v):.2e}, dR {_rel_l2(gR, dR):.2e}, "
          f"dt {_rel_l2(gt, dt):.2e} relative L2")


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_dcp_cal_loss_under_mesh_matches_jax(dcp_inputs, world2, shape, monkeypatch):
    batch, R_ab, t_ab, _, lines = dcp_inputs
    monkeypatch.setattr(JLS, "batch_lines", lambda *a, **k: jnp.asarray(lines))
    loss_j, mon_j = jax.jit(lambda: JLS.dcp_cal_loss(
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(R_ab), jnp.asarray(t_ab),
        jax.random.PRNGKey(0), JLS.LossConfig(n_lines=DCP_LINES, line_chunk=None)))()
    ranks = [out[shape]["dcp"] for out in world2]
    loss = np.mean([r[0] for r in ranks])
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
    for k, want in mon_j.items():
        got = np.mean([r[1][k] for r in ranks])
        np.testing.assert_allclose(got, float(want), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ("loss_pp_wise", "loss_rot_euler_rmse"):  # the global batch's on every rank
        assert ranks[0][1][k] == ranks[1][1][k]
    if shape == (1, 2):  # every sp member has the whole batch: the single process's values
        single = TR.dcp_loss_under(*dcp_inputs[:4], DCP_LINES)
        assert all(r == single for r in ranks)


@pytest.mark.parametrize("shape", SHAPES4)
def test_classical_step_every_factorisation(prob, world4, shape):
    loss, new = TR.classical_step(prob)
    assert np.isfinite(loss)
    for out in world4:
        got_loss, got_new = out[shape]["step"]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-6)
        np.testing.assert_allclose(got_new.numpy(), new.numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the resampler the sharded lines replicate
# ---------------------------------------------------------------------------

def _jax_selection(u4, r, center, n, v1, v2):
    """The JAX package's selection on the port's own candidates: labelled
    by the XLA ``triangle_hits``, filled by its sort-based
    ``_fill_first_n``."""
    fvs = [JG.bbox_face_vertices(jnp.asarray(v)[None])[0] for v in (v1, v2)]
    cand = jnp.asarray(LN.sample_lines(t(u4), r, t(center)).numpy())
    assert cand.shape[0] == LN.ROUNDS * n
    ok = (JL.triangle_hits(fvs[0], cand) > 0) & (JL.triangle_hits(fvs[1], cand) > 0)
    return np.asarray(JL._fill_first_n(cand, ok, n))


@pytest.mark.parametrize("radius", [1.3, 6.0])  # most candidates hit / few do
def test_resample_lines_is_the_jax_selection(radius):
    rng = np.random.default_rng(8)
    v1 = sphere_cloud(200, rng, noise=0.02)
    v2 = sphere_cloud(200, rng, noise=0.02) + np.float32(0.05)
    center, n = v2.mean(0), 128
    u4 = np.asarray(jax.random.uniform(jax.random.PRNGKey(int(radius * 10)),
                                       (4, LN.ROUNDS * n)))
    got = LN.resample_lines(t(u4), radius, t(center), n, t(v1), t(v2))
    np.testing.assert_array_equal(got.numpy(), _jax_selection(u4, radius, center, n, v1, v2))


def test_resample_lines_per_sample_in_a_batch_is_the_jax_selection():
    rng = np.random.default_rng(9)
    v1 = np.stack([sphere_cloud(200, rng, noise=0.02) for _ in range(2)])
    v2 = v1 + np.float32(0.05)
    radius = np.array([1.3, 6.0], np.float32)
    center, n = v2.mean(1), 128
    u4 = rng.random((2, 4, LN.ROUNDS * n), dtype=np.float32)
    got = LN.resample_lines(t(u4), t(radius), t(center), n, t(v1), t(v2))
    for b in range(2):
        want = _jax_selection(u4[b], t(radius[b]), center[b], n, v1[b], v2[b])
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("n", [50, 400])  # enough accepted / a zero-filled tail
def test_fill_first_n_gather_is_the_jax_sort_fill(n):
    rng = np.random.default_rng(n)
    cand = rng.standard_normal((2, 1000, 6)).astype(np.float32)
    ok = rng.random((2, 1000)) < 0.3
    got = LN._fill_first_n_gather(t(cand), t(ok), n)
    for b in range(2):
        want = np.asarray(JL._fill_first_n(jnp.asarray(cand[b]), jnp.asarray(ok[b]), n))
        np.testing.assert_array_equal(got[b].numpy(), want)
    assert (n < 300) == bool((got.abs().sum(-1) > 0).all())
