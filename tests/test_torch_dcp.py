"""The port's DCP (models/dcp.py, models/transplant.py) against the JAX
package's Flax DCP on the CPU.

Flax parameters come from ``model.init`` plus a seeded perturbation (so that
biases and norm scales are not their trivial initial values), as numpy,
through ``dcp_from_flax`` into the port's module. Bars: R and t within 1e-5
for every embedding x pointer x head x cycle; the committed orbax checkpoint
(``tests/data/dcp_tiny_ckpt``) converted the same way reproduces its golden
R and t at atol 1e-5. The MLP-head cases run at emb 256: its GroupNorm(8)
layers need more than one channel per group at width emb / 8 (flax refuses
emb 32, and emb 64 normalises every pooled channel to exactly 0).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.models import dcp as JD
from a_robust_registration_loss_tpu.utils.checkpoint import CheckPointManager
from a_robust_registration_loss_tpu_torch.models import dcp as D
from a_robust_registration_loss_tpu_torch.models.transplant import dcp_from_flax
from torch_port_helpers import flax_params_numpy, perturbed, t

torch.set_num_threads(1)


def _clouds(seed=0, B=2, N=40):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, 3)).astype(np.float32),
            rng.standard_normal((B, N, 3)).astype(np.float32))


def _pair(kw, src, tgt, seed=1):
    """The Flax model with perturbed parameters and the port's module
    carrying the same weights."""
    jm = JD.DCP(JD.DCPConfig(**kw))
    params = perturbed(jm.init(jax.random.PRNGKey(seed), jnp.asarray(src),
                               jnp.asarray(tgt))["params"], seed)
    m = D.DCP(D.DCPConfig(**kw))
    m.load_state_dict(dcp_from_flax(params))
    return jm, params, m


@pytest.mark.parametrize("cycle", [False, True], ids=["inverse", "cycle"])
@pytest.mark.parametrize("head", ["svd", "mlp"])
@pytest.mark.parametrize("pointer", ["identity", "transformer"])
@pytest.mark.parametrize("emb_nn", ["pointnet", "dgcnn"])
def test_forward_matches_flax(emb_nn, pointer, head, cycle):
    src, tgt = _clouds()
    kw = dict(emb_nn=emb_nn, pointer=pointer, head=head, cycle=cycle, ff_dims=64,
              dgcnn_k=8, emb_dims=256 if head == "mlp" else 32)
    jm, params, m = _pair(kw, src, tgt)
    want = jm.apply({"params": params}, jnp.asarray(src), jnp.asarray(tgt))
    got = m(t(src), t(tgt))
    for g, w, name in zip(got, want, ("R_ab", "t_ab", "R_ba", "t_ba")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    np.testing.assert_allclose(np.linalg.det(got[0].detach().numpy()), 1.0, atol=1e-4)


def test_committed_checkpoint_reproduces_goldens():
    d = os.path.join(os.path.dirname(__file__), "data", "dcp_tiny_ckpt")
    with open(os.path.join(d, "config.json")) as f:
        meta = json.load(f)
    kw = {k: meta[k] for k in ("emb_nn", "pointer", "head", "emb_dims", "ff_dims",
                               "n_blocks", "n_heads")}
    rng = np.random.default_rng(meta["input_seed"])
    B, N, _ = meta["shape"]
    src = rng.standard_normal((B, N, 3)).astype(np.float32)
    tgt = rng.standard_normal((B, N, 3)).astype(np.float32)
    template = JD.DCP(JD.DCPConfig(**kw)).init(jax.random.PRNGKey(0), jnp.asarray(src),
                                               jnp.asarray(tgt))["params"]
    state, step = CheckPointManager(d, max_to_keep=1).load({"params": template})
    assert step == 0
    m = D.DCP(D.DCPConfig(**kw))
    m.load_state_dict(dcp_from_flax(flax_params_numpy(state["params"])))
    R, tr, _, _ = m(t(src), t(tgt))
    np.testing.assert_allclose(R.detach().numpy(), np.load(os.path.join(d, "golden_R.npy")),
                               atol=1e-5)
    np.testing.assert_allclose(tr.detach().numpy(), np.load(os.path.join(d, "golden_t.npy")),
                               atol=1e-5)


def test_state_dict_names_are_the_reference_checkpoints():
    """The port's parameter names and shapes are the reference PyTorch
    DCP's, and dcp_from_flax inverts the JAX package's own name map."""
    from a_robust_registration_loss_tpu.models.transplant import dcp_from_state_dict

    src, tgt = _clouds()
    for kw in (dict(emb_nn="dgcnn", pointer="transformer", head="svd", emb_dims=32,
                    ff_dims=64, dgcnn_k=8, n_blocks=2),
               dict(emb_nn="pointnet", pointer="identity", head="mlp", emb_dims=256)):
        _, params, m = _pair(kw, src, tgt)
        sd = m.state_dict()
        ones = (1, 1) if kw["emb_nn"] == "dgcnn" else (1,)
        assert sd["emb_nn.conv1.weight"].shape == (64, 6 if kw["emb_nn"] == "dgcnn" else 3) + ones
        assert "emb_nn.bn5.bias" in sd
        if kw["pointer"] == "transformer":
            for name in ("pointer.model.encoder.layers.1.self_attn.linears.0.weight",
                         "pointer.model.decoder.layers.0.src_attn.linears.3.bias",
                         "pointer.model.decoder.layers.1.feed_forward.w_1.weight",
                         "pointer.model.encoder.layers.0.sublayer.1.norm.a_2",
                         "pointer.model.decoder.layers.0.sublayer.2.norm.b_2",
                         "pointer.model.decoder.norm.a_2", "head.reflect"):
                assert name in sd, name
            assert sd["pointer.model.encoder.layers.0.feed_forward.w_1.weight"].shape == (64, 32)
        else:
            assert {"head.nn.0.weight", "head.nn.7.bias", "head.proj_rot.weight",
                    "head.proj_trans.bias"} <= set(sd)
        # round trip through the JAX package's own torch -> flax map
        back = dcp_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                   n_blocks=kw.get("n_blocks", 1))
        flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                             jax.tree_util.tree_leaves_with_path(tree)}
        want, got = flat(params), flat(back)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dcp_from_flax_raises_on_missing_and_unused_keys():
    src, tgt = _clouds()
    _, params, _ = _pair(dict(emb_nn="pointnet", pointer="transformer", head="svd",
                              emb_dims=32, ff_dims=64), src, tgt)
    missing = {k: dict(v) for k, v in params.items()}
    del missing["pointer"]["enc_norm"]
    with pytest.raises(KeyError, match="enc_norm"):
        dcp_from_flax(missing)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        dcp_from_flax(extra)
    with pytest.raises(KeyError, match="emb_nn"):
        dcp_from_flax({"pointer": params["pointer"]})


def test_knn_graph_feature_matches_jax_and_breaks_ties_by_index():
    src, _ = _clouds(seed=3, N=30)
    src[:, 5] = src[:, 2]    # duplicates: equal distances, and i = j ties
    src[:, 11] = src[:, 2]
    want = np.asarray(JD.knn_graph_feature(jnp.asarray(src), 6))
    got = D.knn_graph_feature(t(src), 6).numpy()
    np.testing.assert_array_equal(got, want)
    idx = D.knn_graph_indices(t(src), 6).numpy()
    # the three copies tie at distance 0: lowest index first, for each of them
    for i in (2, 5, 11):
        np.testing.assert_array_equal(idx[:, i, :3], [[2, 5, 11]] * 2)
    # (neighbour, x_i), not (x_j - x_i, x_i)
    np.testing.assert_array_equal(got[..., 3:], np.broadcast_to(src[:, :, None], got[..., 3:].shape))
    np.testing.assert_array_equal(got[0, 7, :, :3], src[0][idx[0, 7]])


def test_reset_parameters_is_seeded():
    cfg = D.DCPConfig(emb_nn="pointnet", emb_dims=32, ff_dims=64)
    a, b = D.DCP(cfg), D.DCP(cfg)
    D.reset_parameters(a, torch.Generator().manual_seed(7))
    D.reset_parameters(b, torch.Generator().manual_seed(7))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert float(sa["emb_nn.conv1.weight"].abs().max()) <= 1 / np.sqrt(3)
    assert torch.equal(sa["emb_nn.bn1.weight"], torch.ones(64))
