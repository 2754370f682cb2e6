"""The plain reference against the port on the CPU at small sizes, a whole
run of each runner rehearsed there, the control and the faults that a
run's comparison must catch, the frozen FLOP count against PyTorch's
counter, and the run's check for JAX among its modules."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import control, run, spec
from portbench import traffic as TF
from portbench.counts import dcp as CD
from portbench.runners import common
from portbench.reference import classical as RC
from portbench.reference import core
from portbench.reference import dcp as RD

SEED = 2**31 + 977  # more than 32 signed bits hold

SMALL_CLASSICAL = dict(n_lines=300, num_sample=150)
SMALL_POINTS = dict(points=300, epochs=6, check_requests=2)
SMALL_DCP = dict(emb_dims=32, ff_dims=64, dgcnn_k=8, n_lines=120)
SMALL_PAIRS = dict(points=48, train_pairs=8, test_pairs=2, batch=2)


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    """Runs rehearsed on the CPU, the trainer's files under tmp_path, no
    TensorBoard (importing it takes seconds here)."""
    from a_robust_registration_loss_tpu_torch.utils import logging as UL

    monkeypatch.setattr(common, "DEVICE", "cpu")
    monkeypatch.setattr(UL, "_try_tensorboard", lambda logdir: None)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))


def small_cell(name):
    cell = spec.Cell(name, spec.load_benchmark())
    if cell.config["runner"] == "classical":
        cell.config = dict(cell.config, **SMALL_CLASSICAL)
        cell.traffic = dict(cell.traffic, **SMALL_POINTS)
    else:
        cell.config = dict(cell.config, **SMALL_DCP)
        cell.traffic = dict(cell.traffic, **SMALL_PAIRS)
    return cell


def correct(res):
    return all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_classical_reference_follows_the_port_to_the_bit():
    from a_robust_registration_loss_tpu_torch.train import classical as PC

    src, tar, _, _ = TF.pair(dict(TF.load("full"), points=400), SEED, 0)
    cfg = PC.ClassicalConfig(n_epochs=4, n_lines=400, num_sample=200, log_every=2)
    _, hist = PC.run(src, tar, cfg, device="cpu")
    s = dict(n_lines=400, num_sample=200, lr=cfg.lr, lr_halve_every=cfg.lr_halve_every,
             kmin=cfg.kmin, kmax=cfg.kmax, seed=cfg.seed)
    ref = RC.follow(src, tar, s, 4, "cpu")
    np.testing.assert_array_equal(np.float32(ref["loss"]), hist["loss"])
    np.testing.assert_array_equal(np.float32(ref["chamfer"]), hist["chamfer"])
    assert ref["valid"] == hist["valid"].tolist()


def test_dcp_parameters_are_the_ports_in_its_order():
    from a_robust_registration_loss_tpu_torch.models.dcp import DCP, DCPConfig

    m = dict(spec.Cell("dcp_v2.train_b4", spec.load_benchmark()).config)
    model = DCP(DCPConfig(emb_dims=m["emb_dims"], ff_dims=m["ff_dims"], n_heads=m["n_heads"],
                          dgcnn_k=m["dgcnn_k"], n_blocks=m["n_blocks"]))
    shapes = RD.param_shapes(m)[0]
    assert [(k, tuple(p.shape)) for k, p in model.named_parameters()] == list(shapes.items())
    model.load_state_dict(RD.init_weights(m, SEED, "cpu"), strict=True)
    assert sum(p.numel() for p in model.parameters()) == 5_568_896


@pytest.mark.parametrize("name", ["classical_demo.full", "classical_demo.refine",
                                  "dcp_v2.train_b4"])
def test_a_rehearsed_run_is_correct_and_matches_to_the_bit(cpu, name):
    res = small_cell(name).runner().run(small_cell(name), SEED, 1.0, False, 0.0)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert correct(res)
    # on the CPU the port runs its plain versions: the reference's arithmetic
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res["checks"]
    # every limit is compared, the window's first epoch and the twist among them
    assert set(res["checks"]) == set(small_cell(name).limits)
    e2e = res["e2e"]
    assert e2e["setup_s"] > 0 and all(np.isfinite(v) and v > 0 for v in e2e.values())


@pytest.mark.parametrize("name", ["classical_demo.full", "dcp_v2.train_b4"])
def test_the_control_fails_the_comparison(cpu, name):
    cell = small_cell(name)
    if cell.config["runner"] == "classical":
        values = control.classical(cell, SEED)
    else:
        values = control.dcp(cell, SEED)["control"]
    checks = common.checks(values, cell.limits)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("fault", [control.half_batch, control.altered])
def test_the_training_faults_planted_in_the_reference_fail(cpu, fault):
    cell = small_cell("dcp_v2.train_b4")
    checks = common.checks(control.dcp(cell, SEED, (fault,))[fault.__name__], cell.limits)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def _frozen_state(monkeypatch):
    """A step that returns its state unchanged: Adam's update dropped."""
    from a_robust_registration_loss_tpu_torch.train import classical as PC
    from a_robust_registration_loss_tpu_torch.train import harness as PH

    monkeypatch.setattr(PC, "adam_update", lambda cfg, params, opt, grads, valid: (params, opt))
    monkeypatch.setattr(PH, "guarded_update",
                        lambda lr, grads, opt, params, loss, mesh=None: (
                            opt, torch.zeros((), device=loss.device)))


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: the DCP
    loss on the first half of the pairs; the classical step's only pair
    keeps its first half of the lines."""
    from a_robust_registration_loss_tpu_torch.ops import lines as LN
    from a_robust_registration_loss_tpu_torch.train import losses as PL

    loss = PL.dcp_train_loss

    def half(data, R_ab, t_ab, R_ba, t_ba, cfg=PL.LossConfig(), u4=None, generator=None):
        h = R_ab.shape[0] // 2
        data = {k: v[:h] for k, v in data.items()}
        return loss(data, R_ab[:h], t_ab[:h], R_ba[:h], t_ba[:h], cfg,
                    None if u4 is None else u4[:h], generator)

    lines = LN.resample_lines

    def half_lines(*args, **kw):
        out = lines(*args, **kw)
        keep = torch.arange(out.shape[-2], device=out.device) < out.shape[-2] // 2
        return torch.where(keep[:, None], out, 0.0)

    monkeypatch.setattr(PL, "dcp_train_loss", half)
    monkeypatch.setattr(LN, "resample_lines", half_lines)


def _altered_answer(monkeypatch):
    """An answer altered where it is produced: the metric's value, 1% off."""
    from a_robust_registration_loss_tpu_torch.ops import metric as M

    stage2 = M.stage2

    def off(*args, **kw):
        loss, valid = stage2(*args, **kw)
        return loss * (1 + control.ALTERED), valid

    monkeypatch.setattr(M, "stage2", off)


@pytest.mark.parametrize("fault", [_frozen_state, _half_batch, _altered_answer])
@pytest.mark.parametrize("name", ["classical_demo.full", "dcp_v2.train_b4"])
def test_a_broken_timed_path_is_not_correct(cpu, monkeypatch, name, fault):
    """The harness's run, past its look for a card, with the program broken
    underneath; one card, so there is no exchange between cards to drop."""
    fault(monkeypatch)
    cell = small_cell(name)
    res = cell.runner().run(cell, SEED, 0.5, False, 0.0)
    assert not correct(res), res["checks"]


def _late_carry_reset(monkeypatch):
    """The classical carry broken at a block boundary past the third
    epoch: Adam's state starts afresh there."""
    from a_robust_registration_loss_tpu_torch.train import classical as PC

    block = PC._eager_block

    def reset(step, carry, u4_shape, gen, n, state):
        if int(carry[1].count) >= 3:
            carry = (carry[0], PC.init_adam(carry[0]), carry[2])
        return block(step, carry, u4_shape, gen, n, state)

    monkeypatch.setattr(PC, "_eager_block", reset)


def _stale_reshuffle(monkeypatch):
    """The DCP epoch's turnover broken: every epoch's index plan is the
    first epoch's, so the window trains on the first epoch's batches."""
    from a_robust_registration_loss_tpu_torch.data import dataset as DS

    order = DS.DeviceCache._order
    monkeypatch.setattr(DS.DeviceCache, "_order", lambda self, epoch: order(self, 0))


@pytest.mark.parametrize("name,fault", [("classical_demo.full", _late_carry_reset),
                                        ("dcp_v2.train_b4", _stale_reshuffle)])
def test_a_fault_past_the_first_epochs_is_not_correct(cpu, monkeypatch, name, fault):
    """A fault that leaves the first epochs as they were and breaks what
    the window runs after them is caught."""
    fault(monkeypatch)
    cell = small_cell(name)
    res = cell.runner().run(cell, SEED, 0.5, False, 0.0)
    assert not correct(res), res["checks"]
    if name.startswith("dcp"):  # the set-up's epoch is as it was: the window's catches it
        assert all(c["value"] <= c["limit"] for k, c in res["checks"].items()
                   if not k.startswith("window_")), res["checks"]


def test_dcp_flop_count_is_pytorchs():
    m = dict(emb_dims=32, n_blocks=1, n_heads=4, ff_dims=64, dgcnn_k=8, n_lines=50, kmin=1,
             kmax=4, lr=1e-6)
    B, N = 2, 48
    w = RD.init_weights(m, 5, "cpu")
    names = list(RD.param_shapes(m)[0])
    P = {k: v.clone().requires_grad_(k in names) for k, v in w.items()}
    g = torch.Generator().manual_seed(0)
    src, tar = torch.randn(B, N, 3, generator=g), torch.randn(B, N, 3, generator=g)
    neis = core.neighbourhoods(torch.cat([src, tar]), N)
    batch = dict(points_src_sample=src, points_tar_sample=tar, points_based_neighs_src=neis[:B],
                 points_based_neighs_tar=neis[B:], tar_box=core.box_corners(tar),
                 centers=tar.mean(1))
    u4 = torch.rand(B, 4, core.ROUNDS * 50, generator=g)
    with FlopCounterMode(display=False) as fwd:
        RD.train_loss(P, batch, u4, m)
    with FlopCounterMode(display=False) as step:
        loss = RD.train_loss(P, batch, u4, m)
        torch.autograd.grad(loss, [P[k] for k in names])
    assert CD.forward(m, B, N) == fwd.get_total_flops()
    assert CD.train_step(m, B, N) == step.get_total_flops()


def test_the_published_widths_count_about_a_tenth_of_a_teraflop_a_pair():
    m = spec.Cell("dcp_v2.train_b4", spec.load_benchmark()).config
    per_pair = CD.train_step(m, 4, 1024) / 4
    assert 1.0e11 < per_pair < 1.4e11


def test_the_harness_loads_no_jax():
    """Every module a run imports, the port's included, imported in a fresh
    process: no top-level name of JAX or of the JAX package among them."""
    code = ("import portbench.run, portbench.control, portbench.trace;"
            "import portbench.runners.classical, portbench.runners.dcp;"
            "from a_robust_registration_loss_tpu_torch.train import classical, dcp, harness;"
            "from a_robust_registration_loss_tpu_torch.data import dataset;"
            "from portbench.run import forbidden_modules; print(forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["a_robust_registration_loss_tpu_torch.ops", "numpy"]) == []
    assert run.forbidden_modules(["a_robust_registration_loss_tpu.ops", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "a_robust_registration_loss_tpu", "flax", "jax", "jaxlib"]
