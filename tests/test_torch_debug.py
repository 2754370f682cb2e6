"""The port's NaN checks and pdb hooks (utils/debug.py, the trainers'
``--debug_nans`` / ``--debug``) on the CPU.

With the checks on, a batch with a NaN in its source cloud raises
``FloatingPointError`` naming the first module whose output holds the NaN,
where without them the guarded step skips it and leaves the model and the
optimiser state bitwise unchanged, as the JAX CLIs' ``jax_debug_nans`` does
(the batch of tests/test_torch_dcp_train.py's NaN test, and the same for
FMR and RPM-Net). A backward node that returns NaN raises naming the node,
a NaN loss raises, a clean step gives the same losses with the checks as
without, and the checks are off again after their scope. The pdb
excepthook chains the hook it replaces, enters pdb for FloatingPointError
and RuntimeError only, and not when a tracer is set.
"""

import sys

import pytest
import torch

from a_robust_registration_loss_tpu_torch.models import dcp as D
from a_robust_registration_loss_tpu_torch.models import fmr as F
from a_robust_registration_loss_tpu_torch.models import rpmnet as R
from a_robust_registration_loss_tpu_torch.train import dcp as TD
from a_robust_registration_loss_tpu_torch.train import fmr as TF
from a_robust_registration_loss_tpu_torch.train import harness as H
from a_robust_registration_loss_tpu_torch.train import losses as LS
from a_robust_registration_loss_tpu_torch.train import rpmnet as TR
from a_robust_registration_loss_tpu_torch.utils import debug
from torch_port_helpers import make_batch, t

torch.set_num_threads(1)


def _case(name):
    """(model, optimiser state, batch, config, step) of one trainer at a
    small width."""
    loss = LS.LossConfig(n_lines=128)
    b = {k: t(v) for k, v in make_batch(B=2, N=48, F=24).items()}
    if name == "dcp":
        cfg = TD.DCPTrainConfig(loss=loss, model=D.DCPConfig(
            emb_nn="pointnet", pointer="identity", emb_dims=32, ff_dims=64))
        m = TD.init_model(cfg, 0, device="cpu")
        return m, H.adam_init(m.parameters()), b, cfg, TD.train_step, "emb_nn.conv1"
    if name == "fmr":
        b["igt"] = torch.eye(4).expand(2, 4, 4).clone()
        cfg = TF.FMRTrainConfig(train_maxiter=2, loss=loss,
                                model=F.FMRConfig(dim_k=32, num_points=48))
        m = TF.init_model(cfg, 0, device="cpu")
        return m, H.adam_init(m.parameters()), b, cfg, TF.train_step, "encoder.h1.0"
    for tag in ("src", "tar"):
        p = b[f"points_{tag}_sample"]
        b[f"normals_{tag}"] = p / p.norm(dim=-1, keepdim=True)
    cfg = TR.RPMTrainConfig(num_train_reg_iter=1, loss=loss, model=R.RPMNetConfig(
        feat_dim=16, num_neighbors=8, num_sk_iter=2, radius=0.5))
    m = TR.init_model(cfg, 0, device="cpu")
    return (m, H.scheduled_adam_init(m.parameters()), b, cfg, TR.train_step,
            "weights_net.prepool.0")


def _poisoned(batch):
    poisoned = dict(batch)
    poisoned["points_src_sample"] = batch["points_src_sample"].clone()
    poisoned["points_src_sample"][0, 0, 0] = float("nan")
    return poisoned


def _state_tensors(state):
    return list(state.adam) + [state.count] if isinstance(state, H.ScheduledAdamState) \
        else list(state)


@pytest.mark.parametrize("name", ["dcp", "fmr", "rpmnet"])
def test_debug_nans_raises_on_a_poisoned_batch(name):
    m, state, batch, cfg, step, first = _case(name)
    gen = torch.Generator().manual_seed(1)
    state, m1 = step(m, state, batch, cfg, generator=gen)
    assert float(m1["nonfinite_steps"]) == 0.0
    before = {k: v.clone() for k, v in m.state_dict().items()}
    # without the checks the guard skips the batch
    after, m2 = step(m, state, _poisoned(batch), cfg, generator=gen)
    assert float(m2["nonfinite_steps"]) == 1.0
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(after), _state_tensors(state)))
    # with them it raises at the first module whose output holds the NaN
    debug.name_modules(m)
    with debug.anomaly_detection():
        with pytest.raises(FloatingPointError, match=f"NaN in the output of module '{first}'"):
            step(m, state, _poisoned(batch), cfg, generator=gen)
    assert not debug.nan_checks_on() and not torch.is_anomaly_enabled()
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())


def test_clean_steps_give_the_same_losses_under_the_checks():
    losses = []
    for on in (False, True):
        m, state, batch, cfg, step, _ = _case("dcp")
        gen = torch.Generator().manual_seed(3)
        with debug.anomaly_detection(on):
            got = []
            for _ in range(2):
                state, metrics = step(m, state, batch, cfg, generator=gen)
                got.append(float(metrics["loss"]))
        losses.append(got)
    assert losses[0] == losses[1]


def test_a_nan_backward_node_raises_naming_it():
    x = torch.zeros(3, requires_grad=True)
    y = (torch.sqrt(x) * 0.0).sum()  # a finite forward; 0 * inf in the backward
    assert torch.isnan(debug.grad(y, x)[0]).all()  # checks off: NaN comes out
    with debug.anomaly_detection():
        y = (torch.sqrt(x) * 0.0).sum()
        with pytest.raises(FloatingPointError, match="SqrtBackward0"):
            debug.grad(y, x)


def test_a_nan_loss_raises_in_the_guarded_update():
    p = [torch.ones(3)]
    state = H.adam_init(p)
    loss = torch.tensor(float("nan"))
    _, skipped = H.guarded_update(1e-3, [torch.ones(3)], state, p, loss)
    assert float(skipped) == 1.0
    with debug.anomaly_detection(), pytest.raises(FloatingPointError, match="the loss"):
        H.guarded_update(1e-3, [torch.ones(3)], state, p, loss)


def test_enable_and_disable_restore_anomaly_mode():
    assert not debug.nan_checks_on()
    ctx = debug.enable_anomaly_detection()
    try:
        assert debug.nan_checks_on() and torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="a ReLU"):
            torch.nn.ReLU()(torch.tensor([float("nan")]))
        with ctx:  # with_pdb off: a pass-through
            pass
    finally:
        debug.disable_anomaly_detection()
    assert not debug.nan_checks_on() and not torch.is_anomaly_enabled()
    torch.nn.ReLU()(torch.tensor([float("nan")]))  # no check any more


def _raise(exc):
    try:
        raise exc
    except BaseException:
        return sys.exc_info()


def test_pdb_hook_chains_and_skips_under_a_tracer(monkeypatch):
    seen, entered = [], []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    monkeypatch.setattr(debug.pdb, "post_mortem", lambda tb=None: entered.append(tb))
    debug.install_pdb_excepthook()
    debug.install_pdb_excepthook()  # once only: the hook is not chained twice
    for exc in (FloatingPointError("x"), RuntimeError("y"), ValueError("z")):
        sys.excepthook(*_raise(exc))
    assert seen == [FloatingPointError, RuntimeError, ValueError]
    assert len(entered) == 2 and all(tb is not None for tb in entered)
    old = sys.gettrace()
    sys.settrace(lambda *a: None)
    try:
        sys.excepthook(*_raise(FloatingPointError("under a tracer")))
    finally:
        sys.settrace(old)
    assert len(seen) == 4 and len(entered) == 2


def test_debugger_enters_pdb_and_reraises(monkeypatch, capsys):
    entered = []
    monkeypatch.setattr(debug.pdb, "post_mortem", lambda tb=None: entered.append(tb))
    with pytest.raises(FloatingPointError):
        with debug.debugger():
            raise FloatingPointError("boom")
    assert len(entered) == (1 if sys.gettrace() is None else 0)
    with pytest.raises(ValueError):
        with debug.debugger():
            raise ValueError("not numeric")
    with debug.debugger(enabled=False):
        pass
    assert "boom" in capsys.readouterr().out
