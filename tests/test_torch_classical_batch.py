"""The port's batched classical registration (train/classical.py:
prepare_pairs, batch_update, make_batch_step, run_batch) against the JAX
package's ``make_batch_step`` / ``run_batch``.

Lockstep: B = 3 pairs, both sides from the same twists and Adam state
(carried across by the batched ``from_jax_state``), the same lines every
epoch (the JAX step's vmapped resampler read out with a debug callback,
one call per pair, in no fixed order: each call also hands over the pair's
radius, which tells the pairs apart). The JAX step runs op by op, not
jitted: XLA's fusion of the jitted step rounds differently from the same
step op by op (on these pairs one epoch's loss moves by 1.7e-3 relative,
on the same twist and lines, between the two), while the port matches the
op-by-op step to about 1e-7. In one epoch one pair has no usable line on both sides
(zeroed lines): its twist and moments stay bitwise frozen while the shared
Adam count advances, and the next epoch still matches. Bars: each pair's
per-epoch loss within 1e-4 relative, its chamfer within 1e-4 relative or
1e-7 absolute (the float32 rounding of the inner-product expansion of a
squared distance between unit-size clouds: the pairs converge to chamfers
near 5e-5), each pair's first moment within 1e-4 relative L2 every epoch
(the gradients' agreement), the final twists with rtol 1e-3 / atol 1e-5
and the count equal. The twists' atol is a thousandth of the first
epoch's lr 1e-2: Adam scales each component's step by that component's
own gradient history, so a component whose gradient changes sign moves by
up to lr times the moments' relative error (5.6e-6 on these pairs after
10 epochs, on a component of 0.003, with every loss within 6e-5). The batched Adam step alone
matches optax.adam (with the JAX step's masking) to 1e-6 relative.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import lines as JL
from a_robust_registration_loss_tpu.train import classical as JC
from a_robust_registration_loss_tpu_torch.train import classical as TC
from torch_port_helpers import sphere_cloud, t

torch.set_num_threads(1)

B, N_LINES, N_SAMPLE, EPOCHS = 3, 256, 128, 10
FROZEN_PAIR, FROZEN_EPOCH = 1, 4


def _rot_z(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                    np.float32)


@pytest.fixture(scope="module")
def pairs():
    """B ellipsoid pairs, each target a small rotation and shift of its
    noisy source."""
    rng = np.random.default_rng(21)
    scale = np.float32([1.0, 0.7, 0.5])
    src = np.stack([sphere_cloud(300, rng, noise=0.01) * scale for _ in range(B)])
    tar = np.stack([s @ _rot_z(0.1 + 0.05 * b) + np.float32([0.02, -0.01, 0.03])
                    for b, s in enumerate(src)])
    return src.astype(np.float32), tar.astype(np.float32)


@pytest.fixture(scope="module")
def jax_setup(pairs):
    cfg = JC.ClassicalConfig(n_lines=N_LINES, num_sample=N_SAMPLE, line_chunk=None,
                             backend="xla")
    data = JC.prepare_pairs(*pairs, cfg)
    optimizer = optax.adam(JC.lr_schedule(cfg))
    params = jax.vmap(JC.init_twist)(jax.random.split(jax.random.PRNGKey(0), B))
    return cfg, data, optimizer, params, optimizer.init(params)


def _adam_np(opt_state):
    adam = opt_state[0]
    return tuple(np.asarray(x) for x in (adam.count, adam.mu, adam.nu))


def test_lockstep_ten_epochs_with_a_frozen_pair(jax_setup, monkeypatch):
    jcfg, jdata, optimizer, params0, opt0 = jax_setup
    seen = []
    zero = {"radius": None}
    orig = JL.resample_lines

    def recording_resample(key, r, *args, **kwargs):
        lines = orig(key, r, *args, **kwargs)
        if zero["radius"] is not None:
            lines = jnp.where(r == zero["radius"], 0.0, lines)
        jax.debug.callback(lambda rr, x: seen.append((float(rr), np.asarray(x))), r, lines)
        return lines

    monkeypatch.setattr(JL, "resample_lines", recording_resample)
    jstep = JC.make_batch_step(jcfg, jdata, optimizer)

    cfg = TC.ClassicalConfig(n_lines=N_LINES, num_sample=N_SAMPLE)
    data = {k: t(np.asarray(v)) for k, v in jdata.items()}
    params, opt = TC.from_jax_state(np.asarray(params0), _adam_np(opt0), device="cpu")
    assert params.shape == (B, 6) and opt.mu.shape == (B, 6) and opt.count.shape == ()
    carry_t = (params, opt, data["src"])
    carry_j = (params0, opt0, jdata["src"])
    keys = jax.random.split(jax.random.PRNGKey(1), EPOCHS)
    radii = [float(r) for r in np.asarray(jdata["radius"])]
    assert len(set(radii)) == B
    for e in range(EPOCHS):
        before_t, before_j = carry_t, carry_j
        if e == FROZEN_EPOCH:
            zero["radius"] = float(jdata["radius"][FROZEN_PAIR])
            carry_j, mj = jstep(carry_j, keys[e])
            zero["radius"] = None
        else:
            carry_j, mj = jstep(carry_j, keys[e])
        jax.effects_barrier()
        assert len(seen) == B * (e + 1)
        by_radius = dict(seen[B * e:B * (e + 1)])
        lines = np.stack([by_radius[r] for r in radii])
        carry_t, mt = TC.batch_update(cfg, data, carry_t, t(lines))
        want_valid = np.arange(B) != FROZEN_PAIR if e == FROZEN_EPOCH else np.ones(B, bool)
        np.testing.assert_array_equal(np.asarray(mj["valid"]), want_valid)
        np.testing.assert_array_equal(mt["valid"].numpy(), want_valid)
        np.testing.assert_allclose(mt["loss"].numpy(), np.asarray(mj["loss"]), rtol=1e-4,
                                   err_msg=f"epoch {e}")
        np.testing.assert_allclose(mt["chamfer"].numpy(), np.asarray(mj["chamfer"]),
                                   rtol=1e-4, atol=1e-7, err_msg=f"epoch {e}")
        assert int(carry_t[1].count) == int(carry_j[1][0].count) == e + 1
        mu_j = np.asarray(carry_j[1][0].mu)
        mu_err = np.linalg.norm(carry_t[1].mu.numpy() - mu_j, axis=1)
        assert (mu_err <= 1e-4 * np.linalg.norm(mu_j, axis=1)).all(), (e, mu_err)
        if e == FROZEN_EPOCH:
            f = FROZEN_PAIR
            assert torch.equal(carry_t[0][f], before_t[0][f])
            assert torch.equal(carry_t[1].mu[f], before_t[1].mu[f])
            assert torch.equal(carry_t[1].nu[f], before_t[1].nu[f])
            assert not torch.equal(carry_t[0][0], before_t[0][0])
            np.testing.assert_array_equal(np.asarray(carry_j[0][f]), np.asarray(before_j[0][f]))
            np.testing.assert_array_equal(np.asarray(carry_j[1][0].mu[f]),
                                          np.asarray(before_j[1][0].mu[f]))
    np.testing.assert_allclose(carry_t[0].numpy(), np.asarray(carry_j[0]), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(carry_t[2].numpy(), np.asarray(carry_j[2]), rtol=1e-3,
                               atol=1e-5)


def test_batched_adam_matches_masked_optax():
    """adam_update on (B, 6) twists against optax.adam with the JAX batch
    step's masking: per-pair moments freeze, the count only when no pair is
    valid."""
    cfg = TC.ClassicalConfig(lr_halve_every=3)
    optimizer = optax.adam(JC.lr_schedule(JC.ClassicalConfig(lr_halve_every=3)))
    rng = np.random.default_rng(0)
    p = rng.standard_normal((B, 6)).astype(np.float32)
    pj, sj = jnp.asarray(p), optimizer.init(jnp.asarray(p))
    pt, st = TC.from_jax_state(p, _adam_np(sj), device="cpu")
    masks = [[1, 1, 1], [1, 0, 1], [0, 0, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0], [1, 1, 1]]
    for m in masks:
        valid = np.asarray(m, bool)
        g = np.where(valid[:, None], rng.standard_normal((B, 6)), 0).astype(np.float32)
        u, new = optimizer.update(jnp.asarray(g), sj, pj)
        pj = jnp.where(valid[:, None], optax.apply_updates(pj, u), pj)
        sj = jax.tree.map(
            lambda a, b: (jnp.where(valid.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
                          if a.ndim else jnp.where(valid.any(), a, b)), new, sj)
        pt, st = TC.adam_update(cfg, pt, st, t(g), torch.tensor(valid))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)
        for a, b in zip(st, _adam_np(sj)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
    assert int(st.count) == len(masks) - 1


def test_prepare_pairs_clamps_and_matches_jax(pairs):
    jcfg = JC.ClassicalConfig(num_sample=400)  # more seeds than points: clamped
    jd = JC.prepare_pairs(pairs[0][:, :120], pairs[1][:, :130], jcfg)
    td = TC.prepare_pairs(pairs[0][:, :120], pairs[1][:, :130],
                          TC.ClassicalConfig(num_sample=400), device="cpu")
    assert set(td) == set(jd)
    assert td["neis_src"].shape == (B, 120, 9) and td["neis_tar"].shape == (B, 120, 9)
    for k in ("neis_src", "neis_tar", "src", "tar", "center", "radius", "center_src"):
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_run_batch_history_and_callback(pairs):
    fired = []
    cfg = TC.ClassicalConfig(n_epochs=7, n_lines=64, num_sample=64, log_every=3)
    params, hist = TC.run_batch(
        pairs[0][:2], pairs[1][:2], cfg, device="cpu",
        callback=lambda e, p, m, s: fired.append((e, p.shape, m["chamfer"].shape, s.shape)))
    assert params.shape == (2, 6)
    assert {k: v.shape for k, v in hist.items()} == {
        "loss": (7, 2), "chamfer": (7, 2), "valid": (7, 2)}
    assert np.isfinite(hist["loss"]).all() and hist["valid"].all()
    assert fired == [(e, (2, 6), (2,), (2, 300, 3)) for e in (3, 6, 7)]


def test_run_batch_converges():
    """B = 2 rotated-and-shifted spheres: each pair's chamfer falls below
    half of its start (the bar of the JAX package's batched test)."""
    rng = np.random.default_rng(5)
    base = sphere_cloud(128, rng)
    srcs, tars = [], []
    for a in (0.25, -0.2):
        src = base + rng.standard_normal(base.shape).astype(np.float32) * 0.01
        srcs.append(src)
        tars.append(src @ _rot_z(a) + np.float32([0.05, 0.0, -0.02]))
    cfg = TC.ClassicalConfig(n_epochs=120, n_lines=512, num_sample=128, log_every=40,
                             seed=3)
    params, hist = TC.run_batch(np.stack(srcs), np.stack(tars), cfg, device="cpu")
    assert params.shape == (2, 6)
    assert hist["chamfer"].shape == (120, 2)
    start, end = hist["chamfer"][0], hist["chamfer"][-1]
    assert (end < start * 0.5).all(), (start, end)
    assert np.isfinite(hist["loss"]).all()
