"""RPM-Net's model (models/rpmnet.py), the ball query and grouping of
ops/geometry.py, and the weight carriers of models/transplant.py against
the JAX package's, on the CPU, at feat_dim 16, 8 neighbours, N of 64 to
128 points, 3 Sinkhorn iterations, B = 2.

The ball query keeps a point where its squared distance, by the
inner-product expansion, is <= r^2: a rounding knife edge on which XLA:CPU
(which contracts multiply-adds) and PyTorch may disagree. So the ball
queries are held to JAX's indices exactly except in the rows that hold a
pair whose float64 d^2 lies within 1e-6 r^2 of r^2 (counted and printed),
and everything downstream of them takes the port's indices on both sides:
the JAX package's ``query_ball_point_excl`` (or ``query_ball_point``) is
patched inside the test to call the port's on the JAX side's own inputs.

Bars: indices and grouped rows exact; ``sample_and_group_multi``'s
features within 1e-5; ``sinkhorn`` within 3e-6, the JAX package's own bar
against the reference (tests/test_models.py); ``compute_rigid_transform``
within 1e-5, a reflection (det < 0) and a NaN covariance included; the
whole model's transforms, Sinkhorn matrices, beta and alpha within 1e-5
over 2 iterations in both annealing variants; a reference-layout state
dict (weights_dim 3) through the JAX ``rpmnet_from_state_dict`` and the
port's loader within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.models import rpmnet as JR
from a_robust_registration_loss_tpu.models import transplant as JT
from a_robust_registration_loss_tpu.ops import geometry as JG
from a_robust_registration_loss_tpu_torch.models import rpmnet as R
from a_robust_registration_loss_tpu_torch.models import transplant as T
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from torch_port_helpers import perturbed, port_indices_on_jax_inputs, sphere_cloud, t

torch.set_num_threads(1)
SMALL = dict(feat_dim=16, num_neighbors=8, num_sk_iter=3, radius=0.5)


def rpm_clouds(seed, B=2, N=96, rot=0.3):
    """B noisy unit-sphere sources with their outward normals, and targets
    rotated about z by ``rot`` and shifted: numpy (src, nsrc, ref, nref)."""
    rng = np.random.default_rng(seed)
    src = np.stack([sphere_cloud(N, rng, noise=0.02) for _ in range(B)])
    nsrc = src / np.linalg.norm(src, axis=-1, keepdims=True)
    Rz = np.array([[np.cos(rot), -np.sin(rot), 0], [np.sin(rot), np.cos(rot), 0],
                   [0, 0, 1]], np.float32)
    ref = (src @ Rz + np.float32([0.05, -0.03, 0.02])).astype(np.float32)
    return src, nsrc.astype(np.float32), ref, (nsrc @ Rz).astype(np.float32)


@pytest.fixture
def port_ball_query(monkeypatch):
    monkeypatch.setattr(JR, "query_ball_point_excl",
                        port_indices_on_jax_inputs(R.query_ball_point_excl))


def _knife_edge_rows(query, points, radius, exclude_self):
    """(B, S) bool: rows holding a pair whose float64 d^2 is within 1e-6 r^2
    of r^2 (the centre itself left out where the query excludes it), and
    the number of such pairs."""
    q, p = query.astype(np.float64), points.astype(np.float64)
    d2 = ((q[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
    edge = np.abs(d2 - radius**2) <= 1e-6 * radius**2
    if exclude_self:
        edge &= ~np.eye(q.shape[1], p.shape[1], dtype=bool)[None]
    return edge.any(-1), int(edge.sum())


def _lattice(n_side=5, spacing=0.25, offset=0.1):
    """An offset cubic lattice: many pairs at exactly the spacing's
    multiples in real arithmetic, whose fp32 d^2 rounds either way."""
    g = np.arange(n_side, dtype=np.float64) * spacing + offset
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return pts.astype(np.float32)


CASES = {
    "sphere_r0.3": (0.3, None), "sphere_r0.5": (0.5, None), "sphere_r0.8": (0.8, None),
    "lattice_r0.5": (0.5, "lattice"),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("excl", [True, False])
def test_ball_query_exact_off_the_knife_edge(case, excl):
    radius, kind = CASES[case]
    rng = np.random.default_rng(3)
    if kind == "lattice":  # sample 0 on the lattice, sample 1 on a sphere
        lat = _lattice()
        xyz = np.stack([lat, sphere_cloud(len(lat), rng, noise=0.02)])
    else:
        xyz = np.stack([sphere_cloud(128, rng, noise=0.02), sphere_cloud(128, rng, noise=0.02)])
    B, N, _ = xyz.shape
    if excl:
        itself = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N))
        got = R.query_ball_point_excl(radius, 8, t(xyz), t(xyz), t(itself).long()).numpy()
        want = np.asarray(JR.query_ball_point_excl(radius, 8, jnp.asarray(xyz), jnp.asarray(xyz),
                                                   jnp.asarray(itself)))
    else:
        got = G.query_ball_point(radius, 8, t(xyz), t(xyz)).numpy()
        want = np.asarray(JG.query_ball_point(radius, 8, jnp.asarray(xyz), jnp.asarray(xyz)))
    assert got.shape == want.shape == (B, N, 8) and got.dtype == np.int64
    edge_rows, edge_pairs = _knife_edge_rows(xyz, xyz, radius, excl)
    differ = (got != want).any(-1)
    print(f"{case} excl={excl}: {edge_pairs} knife-edge pairs in {int(edge_rows.sum())} of "
          f"{B * N} rows; rows that differ {int(differ.sum())}, all on the edge: "
          f"{not (differ & ~edge_rows).any()}")
    np.testing.assert_array_equal(got[~edge_rows], want[~edge_rows])
    assert (~edge_rows).sum() >= B * N // 2
    assert ((got >= 0) & (got < N)).all()
    if excl:  # the centre is never a neighbour: it is the backfill, a suffix
        centre = got == np.arange(N)[None, :, None]
        assert (np.diff(centre.astype(int), axis=-1) >= 0).all()


def test_smallest_k_values():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 50, (3, 7, 40))
    got = G._smallest_k(t(v), 6).numpy()
    np.testing.assert_array_equal(got, np.sort(v, -1)[..., :6])
    np.testing.assert_array_equal(got, np.asarray(JG._smallest_k(jnp.asarray(v), 6)))


def test_sample_and_group_matches_jax(monkeypatch):
    monkeypatch.setattr(JG, "query_ball_point",
                        port_indices_on_jax_inputs(G.query_ball_point))
    rng = np.random.default_rng(9)
    xyz = np.stack([sphere_cloud(100, rng, noise=0.02) for _ in range(2)])
    feats = rng.standard_normal((2, 100, 5)).astype(np.float32)
    start = np.array([0, 13], np.int32)
    got = G.sample_and_group(24, 0.4, 8, t(xyz), t(feats), returnfps=True,
                             start_idx=t(start))
    want = JG.sample_and_group(24, 0.4, 8, jnp.asarray(xyz), jnp.asarray(feats),
                               returnfps=True, start_idx=jnp.asarray(start))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    new_xyz, pts = G.sample_and_group(24, 0.4, 8, t(xyz), start_idx=t(start))
    assert torch.equal(new_xyz, got[0]) and torch.equal(pts, got[1][..., :3])
    for p in (None, feats):
        got = G.sample_and_group_all(t(xyz), None if p is None else t(p))
        want = JG.sample_and_group_all(jnp.asarray(xyz), None if p is None else jnp.asarray(p))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_and_group_multi_matches_jax(port_ball_query):
    src, nsrc, _, _ = rpm_clouds(1)
    got = R.sample_and_group_multi(0.5, 8, t(src), t(nsrc))
    want = JR.sample_and_group_multi(0.5, 8, jnp.asarray(src), jnp.asarray(nsrc))
    assert set(got) == set(want) == {"xyz", "dxyz", "ppf"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # backfilled neighbours (the centre itself): d = 0, both angles to d and
    # the distance 0 on both sides
    idx = R.query_ball_point_excl(0.5, 8, t(src), t(src), torch.arange(96).expand(2, 96))
    back = (idx == torch.arange(96)[None, :, None]).numpy()
    assert back.any() and not back.all()
    ppf = got["ppf"].numpy()
    assert (ppf[back][:, 3] == 0).all() and (np.asarray(want["ppf"])[back][:, 3] == 0).all()
    np.testing.assert_array_equal(ppf[back][:, :2], np.asarray(want["ppf"])[back][:, :2])


@pytest.mark.parametrize("slack", [True, False])
def test_sinkhorn_matches_jax(slack):
    la = np.random.default_rng(2).standard_normal((2, 10, 12)).astype(np.float32) * 3
    got = R.sinkhorn(t(la), 5, slack).numpy()
    want = np.asarray(JR.sinkhorn(jnp.asarray(la), 5, slack))
    np.testing.assert_allclose(got, want, atol=3e-6)


def test_compute_rigid_transform_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((4, 50, 3)).astype(np.float32)
    rot = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(4)])
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    b = (a @ rot + 0.1 * rng.standard_normal((4, 1, 3))).astype(np.float32)
    b[2] = a[2] * np.float32([1, 1, -1])  # a reflection: det(V U^T) < 0
    b[3] += 0.05 * rng.standard_normal(b[3].shape).astype(np.float32)
    w = rng.random((4, 50)).astype(np.float32)
    a_nan = a.copy()
    a_nan[1, 7, 0] = np.nan  # sample 1's covariance is not finite
    for aa in (a, a_nan):
        got = R.compute_rigid_transform(t(aa), t(b), t(w)).numpy()
        want = np.asarray(JR.compute_rigid_transform(jnp.asarray(aa), jnp.asarray(b),
                                                     jnp.asarray(w)))
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.isnan(got[1]).all() and np.isfinite(np.delete(got, 1, 0)).all()
    ok = np.delete(got, 1, 0)[..., :3]
    np.testing.assert_allclose(np.linalg.det(ok), 1.0, atol=1e-5)


def _nets(anneal, src, nsrc, ref, nref, seed=1):
    cfg = R.RPMNetConfig(anneal=anneal, **SMALL)
    jm = JR.RPMNetEarlyFusion(JR.RPMNetConfig(anneal=anneal, **SMALL))
    params = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(x) for x in (src, nsrc, ref, nref)),
                     num_iter=1)["params"]
    params = perturbed(params, seed, scale=0.1)
    m = R.RPMNetEarlyFusion(cfg)
    m.load_state_dict(T.rpmnet_from_flax(params))
    return m, jm, params


def _assert_outputs(got, want, atol=1e-5):
    (tg, eg), (tw, ew) = got, want
    assert len(tg) == len(tw)
    for a, b in zip(tg, tw):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol)
    for k in ("perm_matrices", "beta", "alpha"):
        for a, b in zip(eg[k], ew[k]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol, rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("anneal", ["net", "constant"])
def test_model_matches_jax(port_ball_query, anneal):
    clouds = rpm_clouds(2)
    m, jm, params = _nets(anneal, *clouds)
    with torch.no_grad():
        got = m(*(t(x) for x in clouds), num_iter=2)
    want = jm.apply({"params": params}, *(jnp.asarray(x) for x in clouds), num_iter=2)
    _assert_outputs(got, want)
    if anneal == "constant":
        assert set(params["weights_net"]) == {"anneal_weights"}
        assert list(m.weights_net.state_dict()) == ["anneal_weights"]


def _reference_state_dict(anneal, weights_dim=3, seed=6):
    """Random arrays in the reference RPMNetEarlyFusion's names and shapes:
    the port's, with the annealing outputs 2 + prod(weights_dim). The
    GroupNorm scales are 1 + 0.1 N(0, 1): with scales of N(0, 0.3) as well
    the features of all points come out nearly alike, the Sinkhorn matrix
    is flat to 1e-2, the Kabsch covariance's singular values are 8e-5, 4e-6
    and 3e-7, and a rounding of 2e-8 in the Sinkhorn matrix turns R by 3e-4
    on either side."""
    m = R.RPMNetEarlyFusion(R.RPMNetConfig(anneal=anneal, **SMALL))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in m.state_dict().items():
        shape = tuple(v.shape)
        if k in ("weights_net.postpool.6.weight", "weights_net.postpool.6.bias",
                 "weights_net.anneal_weights"):
            shape = (2 + weights_dim,) + shape[1:]
        x = 0.3 * rng.standard_normal(shape)
        if k.endswith(".weight") and len(shape) == 1:  # a GroupNorm's scale
            x = 1 + x / 3
        sd[k] = x.astype(np.float32)
    return sd


@pytest.mark.parametrize("anneal", ["net", "constant"])
def test_reference_state_dict_loads_as_in_jax(port_ball_query, anneal):
    sd = _reference_state_dict(anneal)
    clouds = rpm_clouds(3, N=64)
    params = JT.rpmnet_from_state_dict(sd)
    jm = JR.RPMNetEarlyFusion(JR.RPMNetConfig(anneal=anneal, **SMALL))
    want = jm.apply({"params": params}, *(jnp.asarray(x) for x in clouds), num_iter=2)
    m = R.RPMNetEarlyFusion(R.RPMNetConfig(anneal=anneal, **SMALL))
    m.load_state_dict(T.rpmnet_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}))
    with torch.no_grad():
        got = m(*(t(x) for x in clouds), num_iter=2)
    _assert_outputs(got, want)
    # the JAX tree carried back gives the same state dict
    back = T.rpmnet_from_flax(params)
    assert back.keys() == m.state_dict().keys()
    for k, v in m.state_dict().items():
        assert torch.equal(back[k], v), k
    other = R.RPMNetEarlyFusion(R.RPMNetConfig(anneal="net" if anneal == "constant"
                                               else "constant", **SMALL))
    with pytest.raises(RuntimeError):
        other.load_state_dict(T.rpmnet_from_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()}))


def test_rpmnet_from_flax_raises_on_stray_parameters():
    params = JT.rpmnet_from_state_dict(_reference_state_dict("net"))
    assert T.rpmnet_from_flax(params).keys() == R.RPMNetEarlyFusion(
        R.RPMNetConfig(**SMALL)).state_dict().keys()
    params["feat_extractor"]["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="no module takes"):
        T.rpmnet_from_flax(params)
    del params["feat_extractor"]["Dense_9"], params["feat_extractor"]["Dense_5"]
    with pytest.raises(KeyError, match="missing"):
        T.rpmnet_from_flax(params)


def test_config_refuses_what_is_not_ported():
    assert R.RPMNetConfig(dtype="bfloat16").dtype == "bfloat16"  # mixed precision is ported
    with pytest.raises(ValueError, match="dtype"):
        R.RPMNetConfig(dtype="float16")
    with pytest.raises(ValueError, match="features"):
        R.RPMNetConfig(features=("ppf", "fpfh"))
    with pytest.raises(ValueError, match="anneal"):
        R.RPMNetConfig(anneal="fixed")


def test_groupnorm_spans_find_forward_and_backward():
    """chip_smoke.py reads the share of RPM-Net's step that its GroupNorm
    passes take from the step's own trace: the host events it attributes
    to them are the passes' operations and the backward nodes those made,
    and nothing of the layers around them."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from a_robust_registration_loss_tpu_torch.models.common import TorchGroupNorm

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), TorchGroupNorm(4, 16),
                                torch.nn.ReLU(), torch.nn.Linear(16, 4))
    x = torch.randn(2, 5, 8)
    with chip_smoke._Spans(model, TorchGroupNorm, "gn"), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x).sum().backward()
    found = chip_smoke.labelled_events(prof.events(), "gn")
    nodes = sorted(e.name.split(": ")[-1] for e in found if e.scope == 1)
    ops = {e.name for e in found if e.scope != 1}
    # the views of the input, the weight, the bias and the output; the
    # statistics; y = (x - mean) * (rsqrt(var + eps) * weight) + bias
    assert nodes == sorted(["ViewBackward0", "MeanBackward1", "SubBackward0", "PowBackward0",
                            "MeanBackward1", "AddBackward0", "SubBackward0", "RsqrtBackward0",
                            "ViewBackward0", "MulBackward0", "ViewBackward0", "MulBackward0",
                            "ViewBackward0", "AddBackward0"])
    assert {"aten::mean", "aten::rsqrt", "aten::pow"} <= ops
    # the engine's sums of broadcast gradients, outside their nodes: to the
    # shapes of the two means (through both subtractions), of the reciprocal
    # deviation, of the weight (two products) and of the bias
    assert sum(e.name == "aten::sum" and e.cpu_parent.name.startswith(
        "autograd::engine::evaluate_function") for e in found) == 6
    assert not ops & {"aten::linear", "aten::addmm", "aten::relu"}
    assert chip_smoke.labelled_ms(prof.events(), "gn") == 0.0  # no device kernel on the CPU
