"""The port's opt-in bf16 mode (the configs' ``dtype="bfloat16"``, the
trainers' ``--dtype bfloat16``) against the JAX package's, on the CPU.

Both sides hold the same fp32 weights (a perturbed Flax tree carried by
``models/transplant.py``). Bars:

- the port's outputs are fp32 and its parameters stay fp32, before and
  after a training step;
- the JAX package's own ``TestMixedPrecision`` bars
  (``tests/test_models.py``), held between the port's bf16 forward and the
  JAX fp32 forward: DCP's R and t within 0.05 (its MLP head 0.08, the JAX
  package's bar there), RPM-Net's transforms within 0.12, FMR's g within
  0.25 and ``loss_ende`` within 10%; det R within 1e-3 of 1;
- placement: on the features before the heads (DCP's embeddings and
  pointer outputs, RPM-Net's first iteration's features, FMR's decoder
  outputs) the port's bf16 lies nearer the JAX bf16 forward than the JAX
  bf16 forward lies to the JAX fp32 one: mean |port - JAX bf16| over mean
  |JAX bf16 - JAX fp32|, averaged over 3 seeds, at most ``PLACEMENT`` =
  0.5. A port that ran in fp32 reads about 1, a cast placed elsewhere
  moves it up. Measured here (each seed): DCP DGCNN 0.43 to 0.45,
  PointNet with the SVD head 0.0005 to 0.14 and with the MLP head 0.19 to
  0.29, RPM-Net 0.045 to 0.076, FMR 0 (its decoder outputs equal). The JAX
  side runs op by op in this process (``_jax_apply``). What is left is
  bf16 rounding that falls differently: both sides round each product
  once, but the two libraries sum in other orders, and a last-bit
  difference in fp32 flips a bf16 rounding about once in 2,000 values of
  DGCNN's first GroupNorm, more with depth;
- FMR's solver passes (f0, the Jacobian, the iterations) run in fp32 under
  bf16: g, r and n_singular equal the fp32 config's bit for bit;
- one training step per trainer in bf16, the port's lines handed to the
  JAX step (as the fp32 step tests do): the loss within ``STEP_RTOL`` of
  the JAX bf16 step's;
- a checkpoint written under bf16 loads under fp32 and back: the
  parameter trees are the same fp32 trees.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a_robust_registration_loss_tpu.models import dcp as JD
from a_robust_registration_loss_tpu.models import fmr as JF
from a_robust_registration_loss_tpu.models import rpmnet as JR
from a_robust_registration_loss_tpu.train import dcp as JTD
from a_robust_registration_loss_tpu.train import fmr as JTF
from a_robust_registration_loss_tpu.train import losses as JLS
from a_robust_registration_loss_tpu.train import rpmnet as JTR
from a_robust_registration_loss_tpu_torch.models import dcp as D
from a_robust_registration_loss_tpu_torch.models import fmr as F
from a_robust_registration_loss_tpu_torch.models import rpmnet as R
from a_robust_registration_loss_tpu_torch.models.transplant import (
    adam_from_optax,
    dcp_from_flax,
    fmr_from_flax,
    rpmnet_from_flax,
)
from a_robust_registration_loss_tpu_torch.train import dcp as TD
from a_robust_registration_loss_tpu_torch.train import fmr as TF
from a_robust_registration_loss_tpu_torch.train import harness as H
from a_robust_registration_loss_tpu_torch.train import losses as LS
from a_robust_registration_loss_tpu_torch.train import rpmnet as TR
from a_robust_registration_loss_tpu_torch.utils import CheckPointManager
from torch_port_helpers import (
    jax_uniforms,
    make_batch,
    perturbed,
    port_indices_on_jax_inputs,
    sphere_cloud,
    t,
)

torch.set_num_threads(1)
PLACEMENT = 0.5
STEP_RTOL = 0.05  # measured: DCP 0.0029, FMR 6.5e-5, RPM-Net 0.0063
SEEDS = (0, 1, 2)
DCP_CASES = {
    "dgcnn_svd": dict(emb_nn="dgcnn", dgcnn_k=8, emb_dims=64, ff_dims=64, n_heads=4),
    "pointnet_svd": dict(emb_nn="pointnet", emb_dims=64, ff_dims=64, n_heads=4),
    "pointnet_mlp": dict(emb_nn="pointnet", head="mlp", emb_dims=256, ff_dims=64, n_heads=4),
}
RPM_SMALL = dict(feat_dim=16, num_neighbors=16, num_sk_iter=3, radius=0.5)
FMR_SMALL = dict(dim_k=64, num_points=64)


def _np(x):
    return np.asarray(x, np.float32)


def _assert_fp32(m, outs):
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert all(o.dtype == torch.float32 for o in outs)


def _ratio(port, jbf, j32):
    return float(np.abs(port - jbf).mean() / np.abs(jbf - j32).mean())


def _jax_apply(jm, params, *args, **kw):
    """(outputs, the intermediates' outputs) of a Flax model, op by op: each
    bf16 result is rounded as the program states it. Under ``jit`` XLA:CPU
    fuses the ops and keeps their bf16 intermediates in fp32 (excess
    precision), and the placement ratios read 0.3 to 1.2 against it."""
    return jm.apply({"params": params}, *args, capture_intermediates=True,
                    mutable=["intermediates"], **kw)


def _capture(module, into):
    """Keep every output of ``module`` (tuples flattened) as fp32 numpy."""
    def hook(mod, args, out):
        for o in out if isinstance(out, tuple) else (out,):
            into.append(o.detach().float().numpy())
    return module.register_forward_hook(hook)


@pytest.mark.parametrize("case", list(DCP_CASES))
def test_dcp_bf16_against_jax(case):
    kw = DCP_CASES[case]
    atol = 0.08 if kw.get("head") == "mlp" else 0.05
    ratios = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        src, tgt = (rng.standard_normal((2, 48, 3)).astype(np.float32) for _ in range(2))
        j32, jbf = JD.DCP(JD.DCPConfig(**kw)), JD.DCP(JD.DCPConfig(dtype="bfloat16", **kw))
        params = perturbed(j32.init(jax.random.PRNGKey(seed), jnp.asarray(src),
                                    jnp.asarray(tgt))["params"], seed)
        feats, outs = {}, {}
        for name, jm in (("j32", j32), ("jbf", jbf)):
            o, st = _jax_apply(jm, params, jnp.asarray(src), jnp.asarray(tgt))
            it = st["intermediates"]
            f = list(it["emb_nn"]["__call__"]) + list(it.get("pointer", {}).get(
                "__call__", [()])[0])
            feats[name] = np.concatenate([_np(x) for x in f], -1)
            outs[name] = [_np(x) for x in o]
        m = D.DCP(D.DCPConfig(dtype="bfloat16", **kw))
        m.load_state_dict(dcp_from_flax(params))
        got = []
        hooks = [_capture(m.emb_nn, got)] + ([_capture(m.pointer, got)] if m.pointer else [])
        with torch.no_grad():
            out = m(t(src), t(tgt))
        for h in hooks:
            h.remove()
        _assert_fp32(m, out)
        for g, w in zip(out[:2], outs["j32"][:2]):
            np.testing.assert_allclose(g.numpy(), w, atol=atol)
        np.testing.assert_allclose(np.linalg.det(out[0].numpy()), 1.0, atol=1e-3)
        ratios.append(_ratio(np.concatenate(got, -1), feats["jbf"], feats["j32"]))
    print(f"DCP {case}: placement ratio by seed {np.round(ratios, 4).tolist()}")
    assert np.mean(ratios) <= PLACEMENT, ratios


def _rpm_clouds(seed, B=2, N=96, rot=0.3):
    rng = np.random.default_rng(seed)
    src = np.stack([sphere_cloud(N, rng, noise=0.02) for _ in range(B)])
    nsrc = (src / np.linalg.norm(src, axis=-1, keepdims=True)).astype(np.float32)
    Rz = np.array([[np.cos(rot), -np.sin(rot), 0], [np.sin(rot), np.cos(rot), 0],
                   [0, 0, 1]], np.float32)
    ref = (src @ Rz + np.float32([0.05, -0.03, 0.02])).astype(np.float32)
    return src, nsrc, ref, (nsrc @ Rz).astype(np.float32)


def test_rpmnet_bf16_against_jax(monkeypatch):
    # the JAX side takes the port's ball queries: d^2 <= r^2 is a rounding
    # knife edge (tests/test_torch_rpmnet.py)
    monkeypatch.setattr(JR, "query_ball_point_excl",
                        port_indices_on_jax_inputs(R.query_ball_point_excl))
    ratios = []
    for seed in SEEDS:
        clouds = _rpm_clouds(seed)
        jargs = [jnp.asarray(x) for x in clouds]
        j32 = JR.RPMNetEarlyFusion(JR.RPMNetConfig(**RPM_SMALL))
        jbf = JR.RPMNetEarlyFusion(JR.RPMNetConfig(dtype="bfloat16", **RPM_SMALL))
        params = perturbed(j32.init(jax.random.PRNGKey(seed), *jargs, num_iter=1)["params"],
                           seed)
        feats, tfs = {}, {}
        for name, jm in (("j32", j32), ("jbf", jbf)):
            (tf, _), st = _jax_apply(jm, params, *jargs, num_iter=2)
            feats[name] = np.concatenate(
                [_np(x) for x in st["intermediates"]["feat_extractor"]["__call__"][:2]], -1)
            tfs[name] = _np(tf[-1])
        m = R.RPMNetEarlyFusion(R.RPMNetConfig(dtype="bfloat16", **RPM_SMALL))
        m.load_state_dict(rpmnet_from_flax(params))
        got = []
        hook = _capture(m.feat_extractor, got)
        with torch.no_grad():
            transforms, ep = m(*(t(x) for x in clouds), num_iter=2)
        hook.remove()
        _assert_fp32(m, transforms + ep["perm_matrices"] + ep["beta"] + ep["alpha"])
        np.testing.assert_allclose(transforms[-1].numpy(), tfs["j32"], atol=0.12)
        np.testing.assert_allclose(np.linalg.det(transforms[-1][..., :3].numpy()), 1.0,
                                   atol=1e-3)
        ratios.append(_ratio(np.concatenate(got[:2], -1), feats["jbf"], feats["j32"]))
    print(f"RPM-Net: placement ratio by seed {np.round(ratios, 4).tolist()}")
    assert np.mean(ratios) <= PLACEMENT, ratios


def _fmr_clouds(seed, B=2, N=64):
    b = make_batch(B=B, N=N, F=16, seed=seed, rot=0.2)
    return b["points_tar_sample"], b["points_src_sample"]


def test_fmr_bf16_against_jax():
    ratios = []
    for seed in SEEDS:
        p0, p1 = _fmr_clouds(seed)
        j32 = JF.SolveRegistration(JF.FMRConfig(**FMR_SMALL))
        jbf = JF.SolveRegistration(JF.FMRConfig(dtype="bfloat16", **FMR_SMALL))
        params = perturbed(j32.init(jax.random.PRNGKey(seed), jnp.asarray(p0),
                                    jnp.asarray(p1), maxiter=1)["params"], seed, scale=0.05)
        aes, outs = {}, {}
        for name, jm in (("j32", j32), ("jbf", jbf)):
            o, st = _jax_apply(jm, params, jnp.asarray(p0), jnp.asarray(p1), maxiter=3)
            aes[name] = np.concatenate(
                [_np(x) for x in st["intermediates"]["decoder"]["__call__"]], -1)
            outs[name] = o
        m = F.SolveRegistration(F.FMRConfig(dtype="bfloat16", **FMR_SMALL))
        m.load_state_dict(fmr_from_flax(params))
        got = []
        hook = _capture(m.decoder, got)
        with torch.no_grad():
            out = m(t(p0), t(p1), maxiter=3)
        hook.remove()
        _assert_fp32(m, [out["g"], out["g_series"], out["r"], out["loss_ende"]])
        np.testing.assert_allclose(out["g"].numpy(), _np(outs["j32"]["g"]), atol=0.25)
        np.testing.assert_allclose(float(out["loss_ende"]), float(outs["j32"]["loss_ende"]),
                                   rtol=0.1)
        ratios.append(_ratio(np.concatenate(got, -1), aes["jbf"], aes["j32"]))
    print(f"FMR: placement ratio by seed {np.round(ratios, 4).tolist()}")
    assert np.mean(ratios) <= PLACEMENT, ratios


def test_fmr_solver_passes_run_fp32_under_bf16():
    p0, p1 = (t(x) for x in _fmr_clouds(0))
    m32 = F.SolveRegistration(F.FMRConfig(**FMR_SMALL))
    mbf = F.SolveRegistration(F.FMRConfig(dtype="bfloat16", **FMR_SMALL))
    mbf.load_state_dict(m32.state_dict())
    passes = []
    mbf.encoder.h1[0].register_forward_pre_hook(lambda mod, a: passes.append(a[0].dtype))
    with torch.no_grad():
        o32, obf = m32(p0, p1, maxiter=3), mbf(p0, p1, maxiter=3)
    # f0, the autoencoder's f1_full, the Jacobian's pass, 3 iterations
    assert passes == [torch.float32, torch.bfloat16] + [torch.float32] * 4
    for k in ("g", "g_series", "r", "n_singular"):
        assert torch.equal(obf[k], o32[k]), k
    assert float(obf["loss_ende"]) != float(o32["loss_ende"])


@pytest.fixture
def shared_lines(monkeypatch):
    """The JAX steps take the port's lines and ball queries (the pattern of
    tests/test_torch_dcp_train.py). Returns (the port's lines, a wrapper
    that jits a JAX step with the lines as its last argument)."""
    monkeypatch.setattr(JR, "query_ball_point_excl",
                        port_indices_on_jax_inputs(R.query_ball_point_excl))
    seen, traced = [], {}
    real = LS.batch_lines

    def record(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    def with_lines(step):
        def run(*args):
            traced["lines"] = args[-1]
            return step(*args[:-1])
        return jax.jit(run)

    monkeypatch.setattr(LS, "batch_lines", record)
    monkeypatch.setattr(JLS, "batch_lines", lambda *a, **k: traced["lines"])
    return seen, with_lines


def _trainer(name):
    """(batch, port config, JAX config, JAX make_steps, port model class and
    transplant, JAX init) of one trainer in bf16 at a small width."""
    loss = dict(n_lines=256)
    if name == "dcp":
        b = make_batch(B=2, N=48, F=24)
        kw = dict(emb_nn="pointnet", pointer="transformer", emb_dims=32, ff_dims=64,
                  n_heads=2, dtype="bfloat16")
        cfg = TD.DCPTrainConfig(lr=1e-3, loss=LS.LossConfig(**loss), model=D.DCPConfig(**kw))
        jcfg = JTD.DCPTrainConfig(lr=1e-3, loss=JLS.LossConfig(line_chunk=None, **loss),
                                  model=JD.DCPConfig(**kw))
        return b, cfg, jcfg, JTD.make_steps, D.DCP, dcp_from_flax, TD.train_step
    if name == "fmr":
        b = make_batch(B=2, N=64, F=32, rot=0.2)
        R_row = np.ascontiguousarray(b["R"].transpose(0, 2, 1))
        igt = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        igt[:, :3, :3] = R_row
        igt[:, :3, 3] = -np.einsum("bij,bj->bi", R_row, b["T"])
        b.update(R=R_row, R_inv=np.ascontiguousarray(b["R"]), igt=igt)
        kw = dict(dim_k=64, num_points=64, maxiter=3, dtype="bfloat16")
        cfg = TF.FMRTrainConfig(lr=1e-5, train_maxiter=3, loss=LS.LossConfig(**loss),
                                model=F.FMRConfig(**kw))
        jcfg = JTF.FMRTrainConfig(lr=1e-5, train_maxiter=3,
                                  loss=JLS.LossConfig(line_chunk=None, **loss),
                                  model=JF.FMRConfig(**kw))
        return b, cfg, jcfg, JTF.make_steps, F.SolveRegistration, fmr_from_flax, TF.train_step
    b = make_batch(B=2, N=64, F=32)
    b["R"] = np.ascontiguousarray(b["R"].transpose(0, 2, 1))
    for tag in ("src", "tar"):
        p = b[f"points_{tag}_sample"]
        b[f"normals_{tag}"] = (p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)
    kw = dict(feat_dim=16, num_neighbors=8, num_sk_iter=3, radius=0.5, dtype="bfloat16")
    cfg = TR.RPMTrainConfig(max_lr=1e-3, loss=LS.LossConfig(**loss), model=R.RPMNetConfig(**kw))
    jcfg = JTR.RPMTrainConfig(max_lr=1e-3, loss=JLS.LossConfig(line_chunk=None, **loss),
                              model=JR.RPMNetConfig(**kw))
    return b, cfg, jcfg, JTR.make_steps, R.RPMNetEarlyFusion, rpmnet_from_flax, TR.train_step


@pytest.mark.parametrize("name", ["dcp", "fmr", "rpmnet"])
def test_bf16_train_step_matches_jax(shared_lines, name):
    b, cfg, jcfg, make_steps, model_cls, from_flax, train_step = _trainer(name)
    seen, with_lines = shared_lines
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    steps = make_steps(jcfg)
    jm, optimizer, jstep = steps[0], steps[1], with_lines(steps[2])
    if name == "rpmnet":
        params = JTR.init_params(jm, jax.random.PRNGKey(1), jb)
    elif name == "fmr":
        params = jm.init(jax.random.PRNGKey(1), jb["points_tar_sample"],
                         jb["points_src_sample"], maxiter=1)["params"]
    else:
        params = jm.init(jax.random.PRNGKey(1), jb["points_src_sample"],
                         jb["points_tar_sample"])["params"]
    params = jax.tree_util.tree_map(jnp.asarray, perturbed(params, 1, scale=0.05))
    m = model_cls(cfg.model)
    m.load_state_dict(from_flax(params))
    names = [k for k, _ in m.named_parameters()]
    jstate = optimizer.init(params)
    adam = jstate[0]
    state = adam_from_optax(jax.tree_util.tree_map(np.asarray, (adam.count, adam.mu, adam.nu)),
                            names, from_flax=from_flax)
    if name == "rpmnet":
        state = H.ScheduledAdamState(state, torch.zeros_like(state.count))
    key = jax.random.PRNGKey(10)
    state, got = train_step(m, state, {k: t(v) for k, v in b.items()}, cfg,
                            u4=t(jax_uniforms(key, 2, 256)))
    _, _, want = jstep(params, jstate, jb, key, jnp.asarray(seen[-1].numpy()))
    assert float(got["nonfinite_steps"]) == 0.0
    assert all(p.dtype == torch.float32 for p in m.parameters())
    adam_state = state.adam if name == "rpmnet" else state
    assert adam_state.mu.dtype == adam_state.nu.dtype == torch.float32
    rel = abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
    print(f"{name} bf16 step: loss {float(got['loss']):.6f}, JAX {float(want['loss']):.6f}, "
          f"rel {rel:.3g}")
    assert rel <= STEP_RTOL


def test_bf16_checkpoint_loads_under_fp32(tmp_path):
    batches = [make_batch(B=2, N=48, F=24, seed=s) for s in range(2)]
    kw = dict(emb_nn="pointnet", pointer="identity", emb_dims=32, ff_dims=64)
    fit = H.FitConfig(epochs=1, exp_dir=str(tmp_path / "bf16"), log_tensorboard=False)
    cfg = TD.DCPTrainConfig(loss=LS.LossConfig(n_lines=128), fit=fit,
                            model=D.DCPConfig(dtype="bfloat16", **kw))
    model, state, hist = TD.train(cfg, batches, log=lambda m: None, device="cpu")
    assert np.isfinite(hist[0]["loss"]) and hist[0]["nonfinite_steps"] == 0.0
    m32 = D.DCP(D.DCPConfig(**kw))
    template = {"params": m32.state_dict(), "opt_state": H.adam_init(m32.parameters()),
                "epoch": 0}
    loaded, _ = CheckPointManager(str(tmp_path / "bf16" / "checkpoints")).load(template)
    m32.load_state_dict(loaded["params"])
    for k, v in model.state_dict().items():
        assert v.dtype == m32.state_dict()[k].dtype and torch.equal(v, m32.state_dict()[k]), k
    assert all(torch.equal(a, b) for a, b in zip(loaded["opt_state"], state))
    # the trainer resumes that run under fp32
    cfg32 = dataclasses.replace(cfg, model=D.DCPConfig(**kw),
                                fit=dataclasses.replace(fit, epochs=2))
    resumed, _, hist = TD.train(cfg32, batches, log=lambda m: None, device="cpu")
    assert [h["epoch"] for h in hist] == [1] and np.isfinite(hist[0]["loss"])
    assert resumed.cfg.dtype == "float32"
