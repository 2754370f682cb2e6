"""The three trainers, their runtime and their CLIs under a (dp, sp) mesh
(train/harness.py, train/{dcp,fmr,rpmnet}.py, parallel/mesh.py), against
the single process on the CPU.

Ranks over gloo from ``torch_parallel_ranks.py`` (which imports no JAX),
small models from the seed-0 weights, lr 1e-6. Bars:

- each trainer's ``train_step`` under (2, 1) and (1, 2), 2 steps on one
  process's lines (``torch_parallel_ranks.steps`` says why): ``batch_lines``
  on one process's first-step inputs gives each rank that process's rows
  and line shard bit for bit, and so do the lines each rank draws under sp
  (the same batch, the same forward); the first step's loss (the mean over
  the dp ranks) within 1e-6 relative of one process's, equal under sp, the
  second's within 1e-5 (Adam turns a near-0 gradient summed in another
  order into a step of +-lr of either sign); each step's gradient, read
  from Adam's first moments (mu_1 = 0.1 g_1, mu_2 = 0.9 mu_1 + 0.1 g_2),
  and the second moment after 2 steps within 1e-4 relative L2; the
  parameters after 2 steps within 1e-5, and equal on the two ranks; the
  update of the 2 steps within 0.1 relative L2 of one process's (Adam's
  first step is lr sign(g), so a near-0 gradient's noisy sign moves it:
  FMR, with the most such parameters, reads 0.02; an update skipped,
  doubled or reversed on a rank reads 1 or more). DCP runs with its cycle
  term, FMR with its AE term and RPM-Net with its outlier term, which
  every sp member computes whole: counted sp times, they would move the
  gradient far past the bar;
- a NaN in one dp rank's rows skips the step on both ranks, the model and
  Adam's state unchanged;
- a batch of 3 under dp = 2 goes whole to both ranks and equals one
  process's steps bit for bit;
- ``Trainer.fit`` under (2, 1) over batches whose last one is smaller: one
  ``metrics.jsonl``, from rank 0, with every record once; a run resumed
  after epoch 0 reproducing the uninterrupted one within 1e-5; at lr 0,
  every metric within 1e-5 of one process's fit;
- each CLI with ``--dp 2 --sp 1`` trains for an epoch at lr 0, one
  ``metrics.jsonl`` and the checkpoints written, DCP's and FMR's losses
  within 1e-5 of the same CLI in one process (RPM-Net's lines part from
  one process's under dp: ``torch_parallel_ranks.steps``); ``--dp`` /
  ``--sp`` parse as the JAX CLIs read them;
- ``parallel.mesh.launch`` joins a world from torchrun's environment, and
  spawns the ranks without it; a failing rank fails the run (a
  subprocess, under a time limit); a world past its ``join_s`` raises
  and its ranks are gone.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from a_robust_registration_loss_tpu_torch.data import make_dataset, objio
from a_robust_registration_loss_tpu_torch.parallel import mesh as PM
from a_robust_registration_loss_tpu_torch.train import dcp, fmr, harness, rpmnet
from a_robust_registration_loss_tpu_torch.utils import logging as ulog
import torch_parallel_ranks as TR
from torch_port_helpers import make_batch, sphere_cloud

torch.set_num_threads(1)
SHAPES = [(2, 1), (1, 2)]
TRAINERS = ["dcp", "fmr", "rpm"]
CLI = {"dcp": (dcp, ["--emb_dims", "32", "--n_heads", "2", "--ff_dims", "32"]),
       "fmr": (fmr, ["--dim_k", "32", "--train_maxiter", "2", "--eval_maxiter", "2"]),
       "rpm": (rpmnet, ["--feat_dim", "16", "--num_neighbors", "8", "--num_sk_iter", "2",
                        "--radius", "0.5", "--train_reg_iter", "1", "--eval_reg_iter", "2"])}


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm())


def _flat(params):
    """The floating-point tensors of a state dict, flat, in float64."""
    return torch.cat([v.reshape(-1).double() for _, v in sorted(params.items())
                      if v.is_floating_point()])


def _second_gradient(steps):
    """The second step's gradient from Adam's first moments:
    mu_2 = 0.9 mu_1 + 0.1 g_2."""
    return (steps[1]["mu"] - 0.9 * steps[0]["mu"]) / 0.1


def _batches():
    """The trainers' batches of 2 (DCP's, FMR's and RPM-Net's contracts),
    DCP's with a NaN in sample 1's source, and DCP's of 3."""
    b = make_batch(B=2, N=48, F=24, seed=1)
    R_row = np.ascontiguousarray(b["R"].transpose(0, 2, 1))
    igt = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    igt[:, :3, :3] = R_row
    igt[:, :3, 3] = -np.einsum("bij,bj->bi", R_row, b["T"])
    f = dict(b, R=R_row, R_inv=np.ascontiguousarray(b["R"]), igt=igt)
    r = dict(b, R=R_row)
    for tag in ("src", "tar"):
        p = b[f"points_{tag}_sample"]
        r[f"normals_{tag}"] = (p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)
    nan = {k: v.copy() for k, v in b.items()}
    nan["points_src_sample"][1, 5, 0] = np.nan
    return {"dcp": b, "fmr": f, "rpm": r, "dcp_nan": nan,
            "dcp_odd": make_batch(B=3, N=48, F=24, seed=2)}


@pytest.fixture(scope="module")
def batches():
    return _batches()


@pytest.fixture(scope="module")
def single_steps(batches):
    return {name: TR.steps(name, batches[name]) for name in TRAINERS}


@pytest.fixture(scope="module")
def world_steps(batches, single_steps, tmp_path_factory):
    handed = {name: ([s["lines"] for s in single_steps[name][0]],
                     single_steps[name][0][0]["inputs"]) for name in TRAINERS}
    return TR.launch(TR.train_steps2, 2, 1, tmp_path_factory.mktemp("steps"),
                     args=(batches, handed))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", TRAINERS)
def test_train_step_under_mesh_matches_one_process(world_steps, single_steps, name, shape):
    want, want_params = single_steps[name]
    dp, sp = shape
    lines = want[0]["lines"]
    n, L = lines.shape[0] // dp, lines.shape[1] // sp
    for r, out in enumerate(world_steps):
        i, j = divmod(r, sp)
        first = out[name, shape][0][0]
        mine = lines[i * n:(i + 1) * n, j * L:(j + 1) * L]
        assert torch.equal(first["replayed"], mine)
        if sp > 1:  # the same batch as one process: the same forward, the same lines
            assert torch.equal(first["lines"], mine)
    for step, rtol in ((0, 1e-6), (1, 1e-5)):
        got = [out[name, shape][0][step]["metrics"]["loss"] for out in world_steps]
        np.testing.assert_allclose(np.mean(got), want[step]["metrics"]["loss"], rtol=rtol)
        if step == 0 and sp > 1:  # the whole batch on each rank: one process's loss
            assert got == [want[0]["metrics"]["loss"]] * 2
    mod, cfg = TR.trainer(name)
    init = _flat(mod.init_model(cfg, 0, "cpu").state_dict())
    for out in world_steps:
        got, params = out[name, shape]
        assert _rel_l2(got[0]["mu"], want[0]["mu"]) <= 1e-4
        assert _rel_l2(_second_gradient(got), _second_gradient(want)) <= 1e-4
        assert _rel_l2(got[1]["nu"], want[1]["nu"]) <= 1e-4
        assert got[1]["count"] == 2
        for k, v in want_params.items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
        assert _rel_l2(_flat(params) - init, _flat(want_params) - init) <= 0.1
    # the ranks of a mesh stay replicas: the same parameters bit for bit
    for k in want_params:
        assert torch.equal(world_steps[0][name, shape][1][k], world_steps[1][name, shape][1][k])


def test_nan_on_one_dp_rank_skips_the_step_on_both(world_steps):
    mod, cfg = TR.trainer("dcp")
    before = mod.init_model(cfg, 0, "cpu").state_dict()
    for out in world_steps:
        (got,), params = out["nan"]
        assert got["metrics"]["nonfinite_steps"] == 1.0 and got["count"] == 0
        assert not got["mu"].any()
        for k, v in before.items():
            assert torch.equal(params[k], v), k


def test_batch_not_dividing_by_dp_equals_one_process(world_steps, batches):
    """The batch whole on each rank and nothing summed over dp: one
    process's steps bit for bit."""
    want, want_params = TR.steps("dcp", batches["dcp_odd"])
    for out in world_steps:
        got, params = out["odd"]
        for g, w in zip(got, want):
            assert g["metrics"] == w["metrics"] and torch.equal(g["lines"], w["lines"])
        for k, v in want_params.items():
            assert torch.equal(params[k], v), k


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """3 pairs in the indexed layout through ``make_dataset.main``."""
    root = tmp_path_factory.mktemp("parallel_cli")
    (root / "src").mkdir()
    objio.write_obj(str(root / "src" / "base.obj"),
                    sphere_cloud(200, np.random.default_rng(0), noise=0.01))
    make_dataset.main(["--sources", str(root / "src" / "*.obj"), "--out", str(root / "data"),
                       "--n_views", "3", "--num_points", "64", "--num_sample", "48",
                       "--rot_mag", "20", "--trans_mag", "0.1", "--indexed",
                       "--device", "cpu"])
    return str(root / "data")


def _cli_argv(name, data, exp):
    """One epoch at lr 0, where a mesh's lines cannot part from one
    process's through the parameters (``torch_parallel_ranks.steps``)."""
    return (["--data_path", data, "--device", "cpu", "--n_pairs", "3", "--train_count", "2",
             "--batch_size", "2", "--n_lines", "64", "--seed", "7", "--epochs", "1",
             "--exp_dir", exp, "--max_lr" if name == "rpm" else "--lr", "0"] + CLI[name][1])


@pytest.fixture(scope="module")
def fit_world(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit")
    b = _batches()
    train = [b["dcp"], make_batch(B=2, N=48, F=24, seed=4), make_batch(B=1, N=48, F=24, seed=5)]
    test = [make_batch(B=2, N=48, F=24, seed=6)]
    clis = {name: _cli_argv(name, data, str(tmp / f"cli_{name}")) + ["--dp", "2"]
            for name in TRAINERS}
    out = TR.launch(TR.fit_and_clis2, 2, 1, tmp, args=(train, test, str(tmp), clis))
    return tmp, train, test, out


def _records(exp):
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_under_mesh_logs_once_and_resumes(fit_world, monkeypatch):
    tmp, train, test, out = fit_world
    monkeypatch.setattr(ulog, "_try_tensorboard", lambda logdir: None)
    single = TR.fit(train, test, str(tmp / "single"), 2, lr=0.0)
    for exp in ("a", "b", "c"):
        recs = _records(str(tmp / exp))
        keys = [(r["tag"], r["step"]) for r in recs]
        assert len(keys) == len(set(keys)) and {s for _, s in keys} == {0, 1}
        assert {r["tag"] for r in recs} == {r["tag"] for r in _records(str(tmp / "single"))}
        assert sorted(os.listdir(tmp / exp / "checkpoints")) == [
            "checkpoints.json", "ckpt-0", "ckpt-1", "ckpt-best"]
    for rank in out:
        assert [h["epoch"] for h in rank["first"]] == [0]
        assert [h["epoch"] for h in rank["resumed"]] == [1]
        for got, want in zip(rank["first"] + rank["resumed"], rank["whole"]):
            for k in ("loss", "test_loss", "loss_intersection", "test_loss_intersection"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        # at lr 0 no ulp of a parameter can part the lines from one process's:
        # every metric, the root-mean-square monitors too, one process's
        for got, want in zip(rank["frozen"], single):
            assert got.keys() == want.keys()
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert out[0]["whole"] == out[1]["whole"]  # the same global metrics on every rank


@pytest.mark.parametrize("name", TRAINERS)
def test_cli_trains_with_dp2(fit_world, data, name, monkeypatch):
    tmp, _, _, out = fit_world
    monkeypatch.setattr(ulog, "_try_tensorboard", lambda logdir: None)
    exp = str(tmp / f"cli_{name}")
    single = CLI[name][0].main(_cli_argv(name, data, str(tmp / f"single_{name}")))[2]
    recs = _records(exp)
    assert len(recs) == len({(r["tag"], r["step"]) for r in recs})
    assert "ckpt-0" in os.listdir(os.path.join(exp, "checkpoints"))
    for rank in out:
        assert [h["epoch"] for h in rank[name]] == [0] and np.isfinite(rank[name][0]["loss"])
        if name != "rpm":  # RPM-Net's lines part at dp: torch_parallel_ranks.steps
            np.testing.assert_allclose(rank[name][0]["loss"], single[0]["loss"], rtol=1e-5)


def test_mesh_flags_read_as_the_jax_clis():
    ap = dcp._parser()
    base = ["--data_path", "d"]
    for flags, shape in (([], None), (["--dp", "2"], (2, 1)), (["--sp", "2"], (1, 2)),
                         (["--dp", "2", "--sp", "2"], (2, 2)),
                         (["--dp", "2", "--eval_only"], None)):
        assert harness.mesh_shape(ap.parse_args(base + flags), ap) == shape
    for bad in (["--dp", "-1"], ["--sp", "0"]):
        with pytest.raises(SystemExit):
            harness.mesh_shape(ap.parse_args(base + bad), ap)


LAUNCH = """
import os, socket, sys
sys.path[:0] = [{tests!r}, {repo!r}]
import torch_parallel_ranks as TR
from a_robust_registration_loss_tpu_torch.parallel import mesh as PM

with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
           MASTER_PORT=str(port))
os.environ.update(env)
print("torchrun", PM.launch(TR.place, 1, 1, device="cpu", timeout_s=60), flush=True)
for k in env:
    del os.environ[k]
PM.launch(TR.touch_then_fail, 2, 1, args=({out!r},), device="cpu", timeout_s=60)
print("not reached")
"""


def test_launch_joins_or_spawns_and_fails_as_one(tmp_path):
    tests = os.path.dirname(os.path.abspath(__file__))
    script = LAUNCH.format(tests=tests, repo=os.path.dirname(tests), out=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120)
    assert "torchrun (0, 1, 1)" in proc.stdout
    assert proc.returncode != 0 and "not reached" not in proc.stdout
    assert "rank 1 fails on purpose" in proc.stderr
    for r, place in ((0, "2 1 0 0"), (1, "2 1 1 0")):
        assert (tmp_path / f"rank{r}").read_text() == place


def test_launch_stops_a_world_past_its_time_limit(tmp_path):
    """A world not done within ``join_s`` raises, and no rank outlives it."""
    with pytest.raises(TimeoutError, match="not done in 10"):
        PM.launch(TR.hang, 2, 1, (str(tmp_path),), device="cpu", timeout_s=60, join_s=10,
                  workdir=str(tmp_path))
    pids = [int(f.read_text()) for f in tmp_path.glob("pid*")]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert not list(tmp_path.glob("tmp*")), "the rendezvous directory outlived the world"
