"""The port's RPM-Net (``models/rpmnet.py``, ``train/rpmnet.py``,
``train/losses.py:rpm_cal_loss``) against the benchmark's plain reference
(``portbench/reference/rpmnet.py``) on seeded random weights, on the CPU,
at 2 partial pairs of 48 points (the benchmark's traffic cut down: 96
points before the crop, keep 0.7 of 68), feat_dim 16, 8 neighbours and
120 lines: both iterations' transforms, the Sinkhorn matrices, beta and
alpha, ``rpm_cal_loss``'s optimised terms, the gradient of every parameter
and one scanned epoch through ``Trainer.fit`` over a CPU ``DeviceCache``
(Adam's first moment and the parameters).

No tolerance: the reference spells out each operation as the port's plain
versions compute it (the same products, reductions and their order, the
ball query's comparison of the same squared distances, the gather a copy),
and both run here on the same CPU kernels, so a sound port agrees with it
to the bit. A change of any rounding in the port fails these tests; that
is their purpose, as the benchmark's comparison on the card holds the
port to the reference within its limits.

Also: the normals of the traffic replay ``portbench/traffic.py:pair``'s
generator, whose points they return bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from a_robust_registration_loss_tpu_torch.data import dataset as DS
from a_robust_registration_loss_tpu_torch.models.rpmnet import RPMNetEarlyFusion
from a_robust_registration_loss_tpu_torch.train import harness as H
from a_robust_registration_loss_tpu_torch.train import losses as LS
from a_robust_registration_loss_tpu_torch.train import rpmnet as TR
from portbench import partial as PT
from portbench import spec
from portbench import traffic as TF
from portbench.reference import core
from portbench.reference import rpmnet as RR
from portbench.runners import dcp as D
from portbench.runners import rpmnet as RN

torch.set_num_threads(1)

SEED = 2**31 + 4099
SMALL = dict(feat_dim=16, num_neighbors=8, radius=0.5, n_lines=120)
PAIRS = dict(points=96, num_points=68)  # ceil(0.7 * 68) = 48 points a cloud


@pytest.fixture(scope="module")
def cell():
    return spec.Cell("rpmnet.train_b8", spec.load_benchmark())


@pytest.fixture(scope="module")
def m(cell):
    return dict(RN.model_settings(cell.config), **SMALL)


@pytest.fixture(scope="module")
def items(cell):
    traffic = dict(cell.traffic, num_sample=cell.config["num_sample"], **PAIRS)
    return RN.make_items(traffic, SEED, 6, TF.STREAM_PAIR, "cpu")


def _batch(items, rows):
    return {k: torch.as_tensor(np.stack([items[i][k] for i in rows])) for k in items[0]}


def _config(cell):
    return RN.program_config(dict(cell.config, **SMALL), "unused", 3)


def _model(cell, weights):
    model = RPMNetEarlyFusion(_config(cell).model)
    model.load_state_dict(weights)
    return model


def test_the_items_are_partial_pairs_with_normals(items):
    it = items[0]
    assert it["points_src_sample"].shape == it["normals_src"].shape == (48, 3)
    assert it["points_based_neighs_src"].shape == (48 * 3, 3)  # F clamped to the cloud
    np.testing.assert_allclose(np.linalg.norm(it["normals_tar"], axis=1), 1.0, atol=1e-6)


def test_the_normals_replay_the_traffic_generator_to_the_bit(cell):
    for i in range(2):
        src, tar, R, t = TF.pair(cell.traffic, SEED, i)
        got = PT.pair(cell.traffic, SEED, i)
        np.testing.assert_array_equal(got[0], src)
        np.testing.assert_array_equal(got[1], tar)
        np.testing.assert_array_equal(got[4], R)
        np.testing.assert_array_equal(got[5], t)


def test_forward_and_endpoints_equal_the_reference(cell, m, items):
    weights = RR.init_weights(m, SEED, "cpu")
    batch = _batch(items, [0, 1])
    with torch.no_grad():
        transforms, ends = TR.forward(_model(cell, weights), batch, m["num_train_reg_iter"])
        ref, ref_ends = RR.forward(weights, batch["points_src_sample"], batch["normals_src"],
                                   batch["points_tar_sample"], batch["normals_tar"], m,
                                   m["num_train_reg_iter"])
    assert len(transforms) == len(ref) == 2
    for a, b in zip(transforms, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for key, ref_key in (("perm_matrices", "perm"), ("beta", "beta"), ("alpha", "alpha")):
        for a, b in zip(ends[key], ref_ends[ref_key]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_loss_terms_and_every_gradient_equal_the_reference(cell, m, items):
    weights = RR.init_weights(m, SEED + 1, "cpu")
    batch = _batch(items, [2, 3])
    u4 = torch.rand((2, 4, core.ROUNDS * m["n_lines"]),
                    generator=torch.Generator().manual_seed(5))
    cfg = _config(cell)
    model = _model(cell, weights)
    transforms, ends = TR.forward(model, batch, m["num_train_reg_iter"])
    losses, _ = LS.rpm_cal_loss(transforms, ends["perm_matrices"], batch, cfg.loss, u4)
    P = {k: v.clone().requires_grad_() for k, v in weights.items()}
    ref_t, ref_ends = RR.forward(P, batch["points_src_sample"], batch["normals_src"],
                                 batch["points_tar_sample"], batch["normals_tar"], m,
                                 m["num_train_reg_iter"])
    inter, reg = RR.cal_loss(ref_t, ref_ends["perm"], batch, u4, m)
    assert float(losses["loss_intersection"].detach()) > 0
    assert float(losses["loss_reg"].detach()) != 0
    torch.testing.assert_close(losses["loss_intersection"], inter, rtol=0, atol=0)
    torch.testing.assert_close(losses["loss_reg"], reg, rtol=0, atol=0)
    names = list(RR.param_shapes(m)[0])
    got = torch.autograd.grad(LS.rpm_total_loss(losses), list(model.parameters()))
    want = torch.autograd.grad(10.0 * reg + 1.0 * inter, [P[k] for k in names])
    for name, a, b in zip(names, got, want):
        assert b.abs().max() > 0, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_a_scanned_epoch_through_fit_equals_the_reference(cell, m, items, tmp_path):
    """``train`` over a CPU ``DeviceCache`` (the scanned epoch's static
    buffers, the split step run eagerly) for one epoch of 3 batches of 2,
    against the reference's epoch over the same rows and uniforms."""
    weights = RR.init_weights(m, SEED + 2, "cpu")
    fit_seed = 17
    cfg = dataclasses.replace(_config(cell), fit=H.FitConfig(
        epochs=1, exp_dir=str(tmp_path), seed=fit_seed, log_tensorboard=False,
        async_checkpoints=False))
    loader = DS.Loader(D.Items(items), 2, shuffle=True, drop_last=True, seed=fit_seed)
    cache = DS.DeviceCache(loader, "cpu")
    model, opt_state, history = TR.train(cfg, cache, None, init_from=weights,
                                         log=lambda msg: None, device="cpu")
    data = {k: torch.as_tensor(np.stack([it[k] for it in items])) for k in items[0]}
    rows = D.orders(fit_seed, 2, len(items), 1)
    ((loss, flat, mu),) = RR.follow(weights, data, rows, m, fit_seed, "cpu")
    names = list(RR.param_shapes(m)[0])
    params = dict(model.named_parameters())
    torch.testing.assert_close(torch.cat([params[k].detach().reshape(-1) for k in names]),
                               flat, rtol=0, atol=0)
    torch.testing.assert_close(opt_state.adam.mu, mu, rtol=0, atol=0)
    assert int(opt_state.adam.count) == int(opt_state.count) == 3
    # the epoch's loss: the same fp32 batch losses averaged in float64, by
    # the harness in batch order and by numpy's pairwise sum: a few float64
    # ulps apart at most
    assert history[0]["loss"] == pytest.approx(loss, rel=1e-12)
    assert not torch.equal(flat, RN.start_flat(weights, m))
