"""The port's CUDA-graph runtime (train/graphs.py, the static-buffer loops of
train/classical.py and train/harness.py) on the CPU, where the graphs' code
runs eagerly through the same static buffers.

- ``classical._loop(mode="static")``, the graph's loop with the step called
  eagerly in the graph's place (the uniforms drawn into one buffer, the
  carry updated in place, the metrics copied into preallocated rows),
  equals the eager loop bit for bit over 20 epochs, single and B = 2: the
  twists, both moments, the count, the moved source, every metric, every
  callback's values.
- The static loop, fed the JAX step's lines, matches the JAX package's
  ``make_step`` / ``make_batch_step`` epoch by epoch within the lockstep
  tests' bar (loss 1e-4 relative, ``tests/test_torch_classical.py``).
- ``Trainer.fit``'s scanned epoch over a ``DeviceCache`` equals the
  streaming fit (``ARRL_NO_DEVICE_CACHE=1``) bit for bit for DCP, FMR and
  RPM-Net (with its pretraining epoch) at a small width, its train metrics
  fetched once an epoch (and the eval metrics once): the counterpart of the
  JAX package's
  ``tests/test_train_harnesses.py:TestDeviceCacheEquality``.
- The graphs raise on CPU tensors, and their launch bookkeeping takes back
  what a capture counted and adds it per replay.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from torch.utils import _pytree

from a_robust_registration_loss_tpu.ops import lines as JL
from a_robust_registration_loss_tpu.train import classical as JC
from a_robust_registration_loss_tpu_torch.data import dataset as DS
from a_robust_registration_loss_tpu_torch.data import objio
from a_robust_registration_loss_tpu_torch.data import precompute
from a_robust_registration_loss_tpu_torch.models import dcp as D
from a_robust_registration_loss_tpu_torch.models import fmr as F
from a_robust_registration_loss_tpu_torch.models import rpmnet as RM
from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
from a_robust_registration_loss_tpu_torch.train import classical as TC
from a_robust_registration_loss_tpu_torch.train import dcp as TD
from a_robust_registration_loss_tpu_torch.train import fmr as TF
from a_robust_registration_loss_tpu_torch.train import graphs
from a_robust_registration_loss_tpu_torch.train import harness as H
from a_robust_registration_loss_tpu_torch.train import losses as LS
from a_robust_registration_loss_tpu_torch.train import rpmnet as TR
from torch_port_helpers import sphere_cloud, t

torch.set_num_threads(1)

N_LINES, N_SAMPLE = 128, 64


def _clouds(B, seed=21):
    """B pairs of noisy ellipsoids, as the lockstep tests draw them."""
    rng = np.random.default_rng(seed)
    scale = np.float32([1.0, 0.7, 0.5])
    src = np.stack([sphere_cloud(300, rng, noise=0.01) * scale for _ in range(B)])
    tar = np.stack([sphere_cloud(300, rng, noise=0.01) * scale for _ in range(B)])
    return src.astype(np.float32), tar.astype(np.float32)


def _classical(batched, cfg, mode, callback=None):
    src, tar = _clouds(2 if batched else 1)
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    if batched:
        data = TC.prepare_pairs(src, tar, cfg, dev)
        params = torch.stack([TC.init_twist(gen) for _ in range(2)])
        step = TC.make_batch_step(cfg, data)
    else:
        data = TC.prepare_pair(src[0], tar[0], cfg, dev)
        params = TC.init_twist(gen)
        step = TC.make_step(cfg, data)
    return TC._loop(cfg, step, params, data["src"], gen, callback, mode=mode)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch2"])
def test_static_loop_equals_the_eager_loop(batched):
    cfg = TC.ClassicalConfig(n_epochs=20, n_lines=N_LINES, num_sample=N_SAMPLE, log_every=6)
    runs = {}
    for mode in ("eager", "static"):
        calls = []
        carry, hist = _classical(batched, cfg, mode,
                                 lambda e, p, m, s: calls.append((e, p, m, s)))
        runs[mode] = carry, hist, calls
    (k0, h0, c0), (k1, h1, c1) = runs["eager"], runs["static"]
    for a, b in zip(_pytree.tree_leaves(k0), _pytree.tree_leaves(k1)):
        assert torch.equal(a, b)  # the twists, Adam's count and moments, the moved source
    assert int(k1[1].count) == 20
    assert h0.keys() == h1.keys() and len(h0["loss"]) == 20
    for k in h0:
        assert h0[k].dtype == h1[k].dtype and np.array_equal(h0[k], h1[k]), k
    assert [c[0] for c in c0] == [c[0] for c in c1] == [6, 12, 18, 20]
    for a, b in zip(c0, c1):
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[3], b[3])
        assert all(np.array_equal(a[2][k], b[2][k]) for k in a[2])


def test_loop_rejects_an_unknown_mode():
    cfg = TC.ClassicalConfig(n_epochs=1, n_lines=N_LINES, num_sample=N_SAMPLE)
    with pytest.raises(ValueError, match="unknown mode"):
        _classical(False, cfg, "scan")


def _jax_lines(batched, jcfg, jdata, epochs, monkeypatch):
    """Run the JAX step ``epochs`` times, op by op (XLA's fusion of the
    jitted step rounds otherwise: ``tests/test_torch_classical_batch.py``),
    and return its initial state, its losses and the lines each epoch drew,
    in pair order."""
    seen = []
    orig = JL.resample_lines

    def recording(key, r, *args, **kwargs):
        lines = orig(key, r, *args, **kwargs)
        jax.debug.callback(lambda rr, x: seen.append((float(rr), np.asarray(x))), r, lines)
        return lines

    monkeypatch.setattr(JL, "resample_lines", recording)
    optimizer = optax.adam(JC.lr_schedule(jcfg))
    if batched:
        params = jax.vmap(JC.init_twist)(jax.random.split(jax.random.PRNGKey(0), 2))
        step = JC.make_batch_step(jcfg, jdata, optimizer)
    else:
        params = JC.init_twist(jax.random.PRNGKey(0))
        step = JC.make_step(jcfg, jdata, optimizer)
    opt = optimizer.init(params)
    carry = (params, opt, jdata["src"])
    radii = [float(r) for r in np.atleast_1d(np.asarray(jdata["radius"]))]
    losses, lines = [], []
    for key in jax.random.split(jax.random.PRNGKey(1), epochs):
        carry, m = step(carry, key)
        losses.append(np.asarray(m["loss"]))
        jax.effects_barrier()
        got = dict(seen)
        seen.clear()
        lines.append(np.stack([got[r] for r in radii]) if batched else got[radii[0]])
    adam = opt[0]
    state = tuple(np.asarray(x) for x in (adam.count, adam.mu, adam.nu))
    return np.asarray(params), state, np.stack(losses), lines


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch2"])
def test_static_loop_matches_jax_in_lockstep(batched, monkeypatch):
    epochs = 8
    src, tar = _clouds(2 if batched else 1)
    jcfg = JC.ClassicalConfig(n_lines=N_LINES, num_sample=N_SAMPLE, line_chunk=None,
                              backend="xla")
    jdata = (JC.prepare_pairs(src, tar, jcfg) if batched
             else JC.prepare_pair(src[0], tar[0], jcfg))
    params0, opt0, jlosses, lines = _jax_lines(batched, jcfg, jdata, epochs, monkeypatch)
    cfg = TC.ClassicalConfig(n_epochs=epochs, n_lines=N_LINES, num_sample=N_SAMPLE,
                             log_every=3)
    data = {k: t(np.asarray(v)) for k, v in jdata.items()}
    params, opt = TC.from_jax_state(params0, opt0, device="cpu")
    update = TC.batch_update if batched else TC.update
    epoch = iter(range(epochs))

    def step(carry, u4):  # the JAX step's lines in place of the uniforms' own
        return update(cfg, data, carry, t(lines[next(epoch)]))

    gen = torch.Generator().manual_seed(0)
    _, hist = TC._loop(cfg, step, params, data["src"], gen, None, mode="static")
    np.testing.assert_allclose(hist["loss"], jlosses, rtol=1e-4)


def _write_pairs(root, n):
    rng = np.random.default_rng(42)
    for i in range(n):
        src = sphere_cloud(64, rng, noise=0.01) + rng.standard_normal(3).astype(np.float32)
        ang = 0.3 + 0.05 * i
        R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                      [0, 0, 1.0]])
        T_ = rng.standard_normal(3) * 0.2
        tar = (src.astype(np.float64) @ R + T_).astype(np.float32)
        objio.write_obj(str(root / f"{i}_src_sample.obj"), src)
        objio.write_obj(str(root / f"{i}_tar_sample.obj"), tar)
        nrm = src / np.linalg.norm(src, axis=1, keepdims=True)
        objio.write_obj(str(root / f"{i}_src_sample_normals.obj"), nrm)
        objio.write_obj(str(root / f"{i}_tar_sample_normals.obj"),
                        (nrm.astype(np.float64) @ R).astype(np.float32))
        np.concatenate([R, T_[:, None]], 1).tofile(str(root / f"{i}_transform.bin"))
    precompute.main(["--data_path", str(root), "--num_sample", "16", "--device", "cpu"])


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("graph_pairs")
    _write_pairs(root, 7)
    return root


_FETCH = H._fetch


def _count_fetches(monkeypatch):
    """The shapes of the stacked metrics each ``_fetch`` reads, in order."""
    fetches = []
    monkeypatch.setattr(H, "_fetch", lambda rows: fetches.append(tuple(rows.shape))
                        or _FETCH(rows))
    return fetches


def _fit(name, pairs, exp_dir, cached, monkeypatch):
    """(history, final parameters, fetches) of 2 epochs of ``name``'s
    ``train``: 5 training pairs in batches of 2 (the last dropped), 2 test
    pairs, from the cache or streamed."""
    if cached:
        monkeypatch.delenv("ARRL_NO_DEVICE_CACHE", raising=False)
    else:
        monkeypatch.setenv("ARRL_NO_DEVICE_CACHE", "1")
    fetches = _count_fetches(monkeypatch)
    fit = H.FitConfig(epochs=2, exp_dir=str(exp_dir), log_tensorboard=False, seed=3,
                      async_checkpoints=False)
    loaders = DS.generate_datasets(DS.DatasetConfig(
        data_path=str(pairs), n=7, train_batch=2, train_count=5, seed=4,
        dcp=name == "dcp", fmr=name == "fmr"), device="cpu")
    loss = LS.LossConfig(n_lines=N_LINES)
    if name == "dcp":
        cfg = TD.DCPTrainConfig(lr=1e-4, loss=loss, fit=fit, model=D.DCPConfig(
            emb_nn="pointnet", emb_dims=16, ff_dims=32, n_heads=2, cycle=True))
        model, _, history = TD.train(cfg, *loaders, log=lambda m: None, device="cpu")
    elif name == "fmr":
        cfg = TF.FMRTrainConfig(lr=1e-4, train_maxiter=2, eval_maxiter=3, loss=loss,
                                fit=fit, model=F.FMRConfig(dim_k=32, num_points=64))
        model, _, history = TF.train(cfg, *loaders, log=lambda m: None, device="cpu")
    else:
        cfg = TR.RPMTrainConfig(max_lr=1e-4, pretrain_epochs=1, loss=loss, fit=fit,
                                model=RM.RPMNetConfig(feat_dim=16, num_neighbors=8,
                                                      radius=0.5, num_sk_iter=2))
        model, _, history = TR.train(cfg, *loaders, log=lambda m: None, device="cpu")
    return history, [p.detach().clone() for p in model.parameters()], fetches


@pytest.mark.parametrize("name", ["dcp", "fmr", "rpm"])
def test_scanned_fit_equals_the_streaming_fit(name, pairs, tmp_path, monkeypatch):
    h0, p0, f0 = _fit(name, pairs, tmp_path / "stream", False, monkeypatch)
    h1, p1, f1 = _fit(name, pairs, tmp_path / "cache", True, monkeypatch)
    assert f0 == []  # streaming: nothing stacked
    # once an epoch: the train metrics (2 batches) and the eval's (2 batches of
    # 1), after RPM-Net's pretraining epoch's train metrics
    assert [s[0] for s in f1] == [2] * (name == "rpm") + [2, 2, 2, 2]
    assert len(h0) == len(h1) == 2
    for a, b in zip(h0, h1):
        assert a == b  # every metric of both passes, bit for bit
        assert "loss" in a and "test_loss" in a
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def test_scanned_epoch_keeps_the_remainder_batch(pairs, tmp_path, monkeypatch):
    """A cache with a remainder (drop_last=False): the full batches through
    the scanned steps, the last through the streaming step, all in one
    fetch."""
    train, _ = DS.generate_datasets(DS.DatasetConfig(
        data_path=str(pairs), n=7, train_batch=2, train_count=5, seed=4, dcp=True),
        device="cpu")
    loss = LS.LossConfig(n_lines=N_LINES)
    cfg = TD.DCPTrainConfig(lr=1e-4, loss=loss, model=D.DCPConfig(
        emb_nn="pointnet", emb_dims=16, ff_dims=32, n_heads=2))
    runs = []
    for cached in (False, True):
        loader = DS.Loader(train.dataset, 2, shuffle=True, drop_last=False, seed=4)
        if cached:
            loader = DS.DeviceCache(loader, device="cpu")
        model = TD.init_model(cfg, 0, "cpu")
        trainer = H.Trainer(
            lambda m, o, b, g: TD.train_step(m, o, b, cfg, generator=g), None,
            H.FitConfig(epochs=1, exp_dir=str(tmp_path / str(cached)), log_tensorboard=False,
                        async_checkpoints=False),
            device="cpu", train_split=TD.train_split(cfg))
        fetches = _count_fetches(monkeypatch)
        _, state, history = trainer.fit(model, H.adam_init(model.parameters()), loader,
                                        log=lambda m: None)
        runs.append((history, int(state.count), fetches))
    (h0, c0, f0), (h1, c1, f1) = runs
    assert h0 == h1 and c0 == c1 == 3
    assert f0 == [] and f1 == [(3, len(h1[0]) - 1)]


def test_graphs_raise_on_cpu_tensors():
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA graph"):
        graphs.Graph(lambda: x + 1, (x,))
    with pytest.raises(ValueError, match="CUDA graph"):
        graphs.step_graph(lambda c, u: (c, u), (x,), (x,))
    with pytest.raises(ValueError, match="CUDA graph"):
        graphs.Segment(lambda y: y * 2)(x)
    with pytest.raises(ValueError, match="CUDA graph"):
        graphs.Segment(lambda: x * 2, params=[torch.nn.Parameter(x.clone())])()


def test_launch_counts_are_taken_back_and_added_per_replay():
    key = IK.instantiation(2, False, False, True)
    IK.launches[key] += 5
    RS.launches["single"] += 1
    before = graphs._snapshot()
    IK.launches[key] += 1  # what a capture's Python counts
    RS.launches["single"] += 1
    RS.launches["batched"] += 2
    counts = graphs._take_back(before)
    assert counts == {("stage1", key): 1, ("resample", "single"): 1,
                      ("resample", "batched"): 2}
    assert IK.launches[key] == 5 and RS.launches["single"] == 1
    assert RS.launches.get("batched", 0) == 0
    for _ in range(3):
        graphs._add(counts)
    assert IK.launches[key] == 8 and RS.launches["single"] == 4
    assert RS.launches["batched"] == 6
    IK.launches.clear()
    RS.launches.clear()


def test_copy_carry_copies_leaf_by_leaf():
    dst = (torch.zeros(2), H.AdamState(torch.zeros((), dtype=torch.int32), torch.zeros(3),
                                       torch.zeros(3)))
    src = (torch.ones(2), H.AdamState(torch.ones((), dtype=torch.int32), torch.full((3,), 2.0),
                                      torch.full((3,), 3.0)))
    keep = list(_pytree.tree_leaves(dst))
    graphs.copy_carry(dst, src)
    assert all(a is b for a, b in zip(keep, _pytree.tree_leaves(dst)))
    assert torch.equal(dst[0], src[0]) and int(dst[1].count) == 1
    assert torch.equal(dst[1].nu, src[1].nu)


def test_device_cache_next_epoch_advances(pairs):
    train, _ = DS.generate_datasets(DS.DatasetConfig(
        data_path=str(pairs), n=7, train_batch=2, train_count=5, seed=4), device="cpu")
    cache = DS.DeviceCache(train, device="cpu")
    cache.set_epoch(3)
    _, full, rem = cache.next_epoch()
    assert cache.epoch == 4 and rem is None
    assert torch.equal(full, cache.device_epoch(3)[1]) and full.shape == (2, 2)
