"""The port's classical registration step (train/classical.py) against the
JAX package.

Lockstep: both sides start from the same twist and Adam state (carried
across by ``from_jax_state``) and see the same lines every epoch: the JAX
``make_step(backend="xla")`` runs as it is, its resampler's lines are read
out of the jitted step with a debug callback, and the port's ``update``
gets them. Bar: per-epoch loss within 1e-4 relative for 10 epochs. The
Adam step alone matches optax.adam to 1e-6 relative; ``lr_schedule`` and
``final_transform`` match exactly / to 1e-6.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.ops import lines as JL
from a_robust_registration_loss_tpu.train import classical as JC
from a_robust_registration_loss_tpu_torch.se3 import se3 as SE3
from a_robust_registration_loss_tpu_torch.train import classical as TC
from torch_port_helpers import sphere_cloud, t

torch.set_num_threads(1)

N_LINES, N_SAMPLE = 256, 128


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(21)
    src = sphere_cloud(300, rng, noise=0.01) * np.float32([1.0, 0.7, 0.5])
    tar = sphere_cloud(300, rng, noise=0.01) * np.float32([1.0, 0.7, 0.5])
    return src.astype(np.float32), tar.astype(np.float32)


@pytest.fixture(scope="module")
def jax_setup(pair):
    cfg = JC.ClassicalConfig(n_lines=N_LINES, num_sample=N_SAMPLE,
                             line_chunk=None, backend="xla")
    data = JC.prepare_pair(*pair, cfg)
    optimizer = optax.adam(JC.lr_schedule(cfg))
    params = JC.init_twist(jax.random.PRNGKey(0))
    return cfg, data, optimizer, params, optimizer.init(params)


def _port_data(jdata):
    return {k: t(np.asarray(v)) for k, v in jdata.items()}


def _adam_np(opt_state):
    adam = opt_state[0]
    return tuple(np.asarray(x) for x in (adam.count, adam.mu, adam.nu))


def test_lockstep_ten_epochs(jax_setup, monkeypatch):
    jcfg, jdata, optimizer, params0, opt0 = jax_setup
    seen = []
    orig = JL.resample_lines

    def recording_resample(*args, **kwargs):
        lines = orig(*args, **kwargs)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), lines)
        return lines

    monkeypatch.setattr(JL, "resample_lines", recording_resample)
    jstep = jax.jit(JC.make_step(jcfg, jdata, optimizer))

    cfg = TC.ClassicalConfig(n_lines=N_LINES, num_sample=N_SAMPLE)
    data = _port_data(jdata)
    params, opt = TC.from_jax_state(np.asarray(params0), _adam_np(opt0), device="cpu")
    carry_t = (params, opt, data["src"])
    carry_j = (params0, opt0, jdata["src"])
    keys = jax.random.split(jax.random.PRNGKey(1), 10)
    losses = []
    for e in range(10):
        carry_j, mj = jstep(carry_j, keys[e])
        lj = float(mj["loss"])
        jax.effects_barrier()
        assert len(seen) == e + 1
        carry_t, mt = TC.update(cfg, data, carry_t, t(seen[e]))
        assert bool(mj["valid"]) and bool(mt["valid"])
        losses.append((lj, float(mt["loss"])))
        np.testing.assert_allclose(float(mt["loss"]), lj, rtol=1e-4,
                                   err_msg=f"epoch {e}")
        np.testing.assert_allclose(float(mt["chamfer"]), float(mj["chamfer"]),
                                   rtol=1e-4)
    np.testing.assert_allclose(carry_t[0].numpy(), np.asarray(carry_j[0]),
                               rtol=1e-3, atol=1e-6)
    assert int(carry_t[1].count) == int(carry_j[1][0].count) == 10


def test_invalid_epoch_freezes_params_moments_and_count(jax_setup, pair):
    jcfg, jdata, optimizer, params0, opt0 = jax_setup
    cfg = TC.ClassicalConfig(n_lines=N_LINES, num_sample=N_SAMPLE)
    data = _port_data(jdata)
    params, opt = TC.from_jax_state(np.asarray(params0), _adam_np(opt0), device="cpu")
    g = torch.Generator().manual_seed(3)
    step = TC.make_step(cfg, data)
    carry, m = step((params, opt, data["src"]),
                    torch.rand((4, 10 * N_LINES), generator=g))
    assert bool(m["valid"]) and int(carry[1].count) == 1
    far = torch.zeros((N_LINES, 6))
    far[:, 0] = 1.0
    far[:, 4] = 100.0  # x-parallel lines far from both clouds
    after, m2 = TC.update(cfg, data, carry, far)
    assert not bool(m2["valid"])
    assert torch.equal(after[0], carry[0])
    for a, b in zip(after[1], carry[1]):
        assert torch.equal(a, b)


def test_adam_update_matches_optax():
    cfg = TC.ClassicalConfig(lr_halve_every=3)
    rng = np.random.default_rng(0)
    p = rng.standard_normal(6).astype(np.float32)
    optimizer = optax.adam(JC.lr_schedule(JC.ClassicalConfig(lr_halve_every=3)))
    pj, sj = jnp.asarray(p), optimizer.init(jnp.asarray(p))
    pt, st = TC.from_jax_state(p, _adam_np(sj), device="cpu")
    for _ in range(7):
        g = rng.standard_normal(6).astype(np.float32)
        u, sj = optimizer.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, u)
        pt, st = TC.adam_update(cfg, pt, st, t(g), torch.tensor(True))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)
        for a, b in zip(st, _adam_np(sj)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)


def test_lr_schedule_halves_at_zero():
    jcfg = JC.ClassicalConfig()
    steps = np.array([0, 1, 999, 1000, 1001, 2500, 4000], np.int32)
    got = TC.lr_schedule(TC.ClassicalConfig())(torch.tensor(steps)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JC.lr_schedule(jcfg)(jnp.asarray(steps))))
    assert got[0] == np.float32(1e-2)


@pytest.mark.parametrize("x", [[0.0, 0.0, 0.0, 0.1, 0.2, 0.3],
                               [0.004, -0.003, 0.002, 0.01, 0.0, 0.0],
                               [0.5, -0.4, 1.2, -0.3, 0.2, 0.1]])
def test_final_transform(x):
    x = np.asarray(x, np.float32)
    Rt, pt, out = TC.final_transform(torch.tensor(x))
    Rj, pj, outj = JC.final_transform(x)
    np.testing.assert_array_equal(out, outj)
    R, p = SE3.exp3(t(x))
    np.testing.assert_allclose(Rt, R.numpy(), atol=1e-6)
    np.testing.assert_allclose(pt, p.numpy(), atol=1e-6)


def test_init_twist_and_prepare_pair(pair):
    g = torch.Generator().manual_seed(0)
    x = TC.init_twist(g)
    assert x.shape == (6,)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(x[:3])), 1e-3, rtol=1e-5)
    # from a given (R, t): log of it plus U(0, 0.6) noise
    Rg, tg = SE3.exp3(torch.tensor([0.2, -0.1, 0.3, 0.5, 0.0, -0.2]))
    y = TC.init_twist(torch.Generator().manual_seed(1), Rg, tg)
    noise = y - torch.tensor([0.2, -0.1, 0.3, 0.5, 0.0, -0.2])
    assert float(noise.min()) >= -1e-5 and float(noise.max()) <= 0.6 + 1e-5

    cfg = JC.ClassicalConfig(num_sample=N_SAMPLE)
    jd = JC.prepare_pair(*pair, cfg)
    td = TC.prepare_pair(*pair, TC.ClassicalConfig(num_sample=N_SAMPLE), device="cpu")
    assert set(td) == set(jd)
    for k in ("neis_src", "neis_tar", "src", "tar", "center", "radius"):
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_apply_twist_matches_jax(pair):
    x = np.asarray([0.3, -0.2, 0.5, 0.1, -0.05, 0.2], np.float32)
    pts = pair[0][:50]
    neis = pair[1][:48].reshape(16, 9)
    pj, nj = JC.apply_twist(jnp.asarray(x), jnp.asarray(pts), jnp.asarray(neis))
    pt, nt = TC.apply_twist(t(x), t(pts), t(neis))
    assert nt.shape == (16, 9)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-6)


def test_run_blocks_history_and_callback(pair):
    fired = []
    cfg = TC.ClassicalConfig(n_epochs=7, n_lines=64, num_sample=64, log_every=3)
    params, hist = TC.run(*pair, cfg, device="cpu",
                          callback=lambda e, p, m, s: fired.append((e, p.shape, s.shape)))
    assert params.shape == (6,)
    assert {k: v.shape for k, v in hist.items()} == {"loss": (7,), "chamfer": (7,), "valid": (7,)}
    assert np.isfinite(hist["loss"]).all()
    assert fired == [(3, (6,), (300, 3)), (6, (6,), (300, 3)), (7, (6,), (300, 3))]
