"""The RPM-Net cell: its partial traffic with normals, the readers of its
per-layer metrics on a profile fixture (``fixtures/rpmnet_window.json``:
raw events in the shape the profiler gives them, written out by hand so
that each number can be worked out: two train steps of three pieces with
their solves, backward and update, a test step, a checkpoint), a whole run
rehearsed on the CPU, the control and the faults its comparison must
catch, and the frozen FLOP count against PyTorch's counter."""

import json
import math
import os

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.utils.flop_counter import FlopCounterMode

from portbench import control_rpmnet as CTL
from portbench import partial as PT
from portbench import spec
from portbench import trace as TR
from portbench.counts import kernels as K
from portbench.counts import peaks
from portbench.counts import rpmnet as CR
from portbench.reference import core
from portbench.reference import rpmnet as RR
from portbench.runners import common

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "rpmnet.train_b8"
SEED = 2**31 + 977  # more than 32 signed bits hold
SMALL_MODEL = dict(feat_dim=16, num_neighbors=8, radius=0.5, n_lines=120)
SMALL_PAIRS = dict(points=96, num_points=64, train_pairs=8, test_pairs=4, batch=2, test_batch=2)


class Event:
    """A raw profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, device, start, dur, corr):
        self._v = (name, DeviceType.CUDA if device == "cuda" else DeviceType.CPU, start,
                   dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


@pytest.fixture(scope="module")
def cell():
    return spec.Cell(CELL, spec.load_benchmark())


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    """Runs rehearsed on the CPU, the trainer's files under tmp_path, no
    TensorBoard."""
    from a_robust_registration_loss_tpu_torch.utils import logging as UL

    monkeypatch.setattr(common, "DEVICE", "cpu")
    monkeypatch.setattr(UL, "_try_tensorboard", lambda logdir: None)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))


def small_cell():
    c = spec.Cell(CELL, spec.load_benchmark())
    c.config = dict(c.config, **SMALL_MODEL)
    c.traffic = dict(c.traffic, **SMALL_PAIRS)
    return c


def window(drop=()):
    """The fixture's digest, without the spans named in ``drop``, with the
    counts a run adds beside it."""
    with open(os.path.join(HERE, "fixtures", "rpmnet_window.json")) as f:
        events = [Event(*e) for e in json.load(f) if e[0] not in drop]
    d = TR.digest(events)
    d.update(train_steps=2, train_flops=4.0e9, eval_flops=1.0e9, stage1_kernel="stage1_kernel",
             resample_kernel="resample_kernel", gather_kernel="gather_fwd",
             gather_bytes=CR.gather_bytes(1, 64, 8))
    d["stage1_ops"], d["stage1_bytes"] = K.stage1(8, 10000, 717, 717, 4)
    d["resample_ops"], d["resample_bytes"] = K.resample(8, 100000, 200000)
    return d


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

def test_a_seed_repeats_and_two_seeds_differ(cell):
    a = PT.partial_pair(cell.traffic, SEED, 3)
    for x, y in zip(a, PT.partial_pair(cell.traffic, SEED, 3)):
        np.testing.assert_array_equal(x, y)
    for other in (PT.partial_pair(cell.traffic, SEED + 1, 3),
                  PT.partial_pair(cell.traffic, SEED, 4)):
        assert not np.array_equal(a[0], other[0]) and not np.array_equal(a[2], other[2])


def test_the_crop_keeps_717_points_with_unit_normals(cell):
    t = cell.traffic
    assert math.ceil(t["keep"] * t["num_points"]) == 717
    for i in range(4):
        src, tar, n_src, n_tar, R, _ = PT.partial_pair(t, SEED, i)
        assert src.shape == tar.shape == n_src.shape == n_tar.shape == (717, 3)
        for n in (n_src, n_tar):
            np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)
        # the crop keeps a half-space's worth: the kept points of the full
        # cloud lie on one side of a plane, the other 30% are gone
        full = PT.pair(t, SEED, i)[0]
        assert len({tuple(p) for p in src} - {tuple(p) for p in full}) == 0
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_the_item_holds_the_motion_in_the_plain_form():
    spec_ = dict(points=512, noise=0.0, euler_max_deg=45.0, trans_range=0.5)
    src, tar, n_src, n_tar, R, t = PT.pair(spec_, 11, 0)
    it = PT.rpm_item(src, tar, n_src, n_tar, R, t)
    # the moved source lies on the target's surface: row convention
    moved = it["points_src_sample"] @ it["R"] + it["T"]
    d = ((moved[:, None, :] - it["points_tar_sample"][None]) ** 2).sum(-1).min(1)
    assert np.sqrt(d).mean() < 0.1
    # the normals turn with the points
    np.testing.assert_allclose(n_src @ it["R"], PT.pair(spec_, 11, 0)[2] @ R.T, atol=1e-6)
    np.testing.assert_allclose(it["igt"][:3, :3], it["R"], atol=0)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def test_the_readers_on_the_fixture(cell):
    d = window()
    got = {m["name"]: cell.reader(m["name"])(d) for m in cell.per_layer}
    assert len(got) == 8
    # a step's pieces put 3,000 + 1,000 and 2,000 + 500 + 1,000 ns of kernels on
    # the card, its backward 4,000, its solve 600, its update 500 (and a fill,
    # no kernel): over 2 steps
    assert got["forward_ms.rpm"] == pytest.approx(7.5e-3)
    assert got["backward_ms.rpm"] == pytest.approx(4.0e-3)
    assert got["step_device_ms.rpm"] == pytest.approx(12.6e-3)
    # a solve (4,000 ns) is busy 3,000 with the piece before it and 600 with the SVD
    assert got["solve_idle_ms.rpm"] == pytest.approx(0.4e-3)
    assert got["eval_ms.rpm"] == pytest.approx(19e-3)
    work = 4.0e9 + 1.0e9 + 2 * d["stage1_ops"] + 2 * d["resample_ops"]
    assert got["step_mfu.rpm"] == pytest.approx(100 * work / (89e-6 * peaks.FP32_OPS))
    # 4 gathers in the train pass (the test pass's is not read), 1,000 ns each
    bound = peaks.bound_s(0, d["gather_bytes"])
    assert got["gather_roofline.rpm"] == pytest.approx(100 * 4 * bound / 4e-6)
    # busy: 12,700 ns a train step, 6,500 in the test pass, 2,000 the checkpoint's copy
    assert got["device_idle.rpm"] == pytest.approx(100 * (1 - 33_900 / 89_000))


def test_every_reader_returns_none_on_an_empty_window(cell):
    empty = TR.digest([Event("portbench.window_start", "cpu", 0, 0, 1),
                       Event("portbench.window_end", "cpu", 1000, 0, 2)])
    empty.update(train_steps=2, stage1_kernel="stage1_kernel",
                 resample_kernel="resample_kernel", gather_kernel="gather_fwd")
    for m in cell.per_layer:
        assert cell.reader(m["name"])(empty) is None, m["name"]


def test_a_window_without_step_spans_reads_no_forward_or_backward(cell):
    """The parent of the step spans traces a fit's passes and solves, not
    its forward, backward and update: those two readers find nothing, the
    others read what they read with them."""
    whole = {m["name"]: cell.reader(m["name"])(window()) for m in cell.per_layer}
    d = window(drop=("arrl.step.forward", "arrl.step.backward", "arrl.step.update"))
    got = {m["name"]: cell.reader(m["name"])(d) for m in cell.per_layer}
    assert got.pop("forward_ms.rpm") is None and got.pop("backward_ms.rpm") is None
    assert got == {k: whole[k] for k in got}


def test_the_gather_is_among_the_checked_launches(monkeypatch):
    from a_robust_registration_loss_tpu_torch.ops.cuda import gather as GA

    from portbench.runners import rpmnet as RN

    monkeypatch.setitem(GA.launches, "fwd", 5)
    assert RN.launches()[RN.GATHER_KERNEL] == 5
    d = window()
    d["counted"] = {RN.GATHER_KERNEL: 6, "stage1_kernel": 2, "resample_kernel": 2}
    assert not TR.complete(d)
    d["counted"][RN.GATHER_KERNEL] = 5
    assert TR.complete(d)


# ---------------------------------------------------------------------------
# the run, its comparison, the counts
# ---------------------------------------------------------------------------

def test_the_reference_parameters_are_the_ports_in_its_order(cell):
    from a_robust_registration_loss_tpu_torch.models.rpmnet import (RPMNetConfig,
                                                                    RPMNetEarlyFusion)

    m = cell.config
    model = RPMNetEarlyFusion(RPMNetConfig(feat_dim=m["feat_dim"],
                                           num_neighbors=m["num_neighbors"]))
    shapes = RR.param_shapes(m)[0]
    assert [(k, tuple(p.shape)) for k, p in model.named_parameters()] == list(shapes.items())
    model.load_state_dict(RR.init_weights(m, SEED, "cpu"), strict=True)
    assert sum(p.numel() for p in model.parameters()) == m["parameters"] == 905_154


def test_a_rehearsed_run_is_correct_and_matches_to_the_bit(cpu):
    c = small_cell()
    res = c.runner().run(c, SEED, 1.0, False, 0.0)
    assert res["attempted"] > 0 and res["failed"] == 0
    # on the CPU the port runs its plain versions: the reference's arithmetic
    assert all(v["value"] == 0.0 for v in res["checks"].values()), res["checks"]
    assert set(res["checks"]) == set(c.limits)
    assert all(np.isfinite(v) and v > 0 for v in res["e2e"].values())


@pytest.mark.parametrize("reading", ["control"] + [f.__name__ for f in CTL.FAULTS])
def test_the_control_and_every_fault_fail_the_comparison(cpu, reading):
    c = small_cell()
    faults = [f for f in CTL.FAULTS if f.__name__ == reading]
    checks = common.checks(CTL.readings(c, SEED, faults)[reading], c.limits)
    assert any(v["value"] > v["limit"] for v in checks.values()), checks


def test_the_flop_count_is_pytorchs():
    m = dict(spec.Cell(CELL, spec.load_benchmark()).config, feat_dim=16, num_neighbors=8,
             radius=0.5, n_lines=50)
    B, N = 2, 40
    P = {k: v.clone().requires_grad_() for k, v in RR.init_weights(m, 5, "cpu").items()}
    g = torch.Generator().manual_seed(0)
    src, tar, n_src, n_tar = (torch.randn(B, N, 3, generator=g) for _ in range(4))
    neis = core.neighbourhoods(torch.cat([src, tar]), N)
    batch = dict(points_src_sample=src, points_tar_sample=tar, normals_src=n_src,
                 normals_tar=n_tar, points_based_neighs_src=neis[:B],
                 points_based_neighs_tar=neis[B:], tar_box=core.box_corners(tar),
                 centers=tar.mean(1))
    u4 = torch.rand(B, 4, core.ROUNDS * 50, generator=g)
    with FlopCounterMode(display=False) as fwd, torch.no_grad():
        RR.forward(P, src, n_src, tar, n_tar, m, m["num_eval_reg_iter"])
    with FlopCounterMode(display=False) as step:
        torch.autograd.grad(RR.train_loss(P, batch, u4, m), list(P.values()))
    assert CR.forward(m, B, N, m["num_eval_reg_iter"]) == fwd.get_total_flops()
    assert CR.train_step(m, B, N) == step.get_total_flops()


def test_the_published_widths_count_about_a_third_of_a_teraflop_a_step(cell):
    m = cell.config
    assert 2.5e11 < CR.train_step(m, 8, 717) < 3.0e11
    # the gather of a feature pass: the table of 717 rows of 6 floats, read
    # once, then 717 x 64 int64 indices and the rows they pick
    assert CR.gather_bytes(8, 717, 64) == 8 * 717 * 24 + 8 * 717 * 64 * (8 + 24)
    # the bound the PR 5 table gives RPM-Net's ball query at (4, 1,024, 6,
    # 65,536): 0.00253 ms
    assert peaks.bound_s(0, CR.gather_bytes(4, 1024, 64)) == pytest.approx(2.53e-6, rel=2e-3)
