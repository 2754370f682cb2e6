"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel has
no CPU mode. The file imports no JAX, so it also runs where only PyTorch is
installed; the suite's conftest.py imports JAX, hence ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Bars: stage 1 counts, slot indices and slot coordinates exactly equal (both
sides round every operation on its own); resampler candidate geometry within
1e-4, at most 0.1% of labels differing and acceptance within 10% (the bars
the JAX package holds its own two resampler paths to); each wrapper call
counts one launch; the rigid metric on the card within 1e-4 relative (loss)
and 5e-4 relative L2 (gradient) of the plain path on the CPU.
"""

import numpy as np
import pytest
import torch

from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
from a_robust_registration_loss_tpu_torch.se3 import se3
from a_robust_registration_loss_tpu_torch.train import classical as TC

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _cloud(n, seed):
    """A noisy Fibonacci ellipsoid (n, 3) float32."""
    rng = np.random.default_rng(seed)
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    th = np.pi * (1 + 5**0.5) * i
    p = np.stack([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th),
                  np.cos(phi)], -1) * np.array([1.0, 0.7, 0.5])
    return (p + rng.standard_normal(p.shape) * 0.01).astype(np.float32)


def _problem(f1, f2, n_lines, seed=0):
    """Neighbourhoods of two clouds (F1, 9), (F2, 9) and n_lines resampled
    lines (L, 6), made on the CPU by the port's plain path."""
    v1, v2 = torch.tensor(_cloud(1200, seed)), torch.tensor(_cloud(1100, seed + 1))
    n1 = G.sample_neighs(v1, f1, 3).reshape(f1, 9)
    n2 = G.sample_neighs(v2, f2, 3).reshape(f2, 9)
    g = torch.Generator().manual_seed(seed)
    u4 = torch.rand((4, LN.ROUNDS * n_lines), generator=g)
    lines = LN.resample_lines(u4, torch.tensor(2.4), v2.mean(0), n_lines, v1, v2)
    return n1, n2, lines


@pytest.mark.cuda
@pytest.mark.parametrize("f1,f2,n_lines", [(333, 301, 257), (1000, 700, 3000)])
def test_stage1_kernel_matches_plain(cuda_device, f1, f2, n_lines):
    n1, n2, lines = (x.to(cuda_device) for x in _problem(f1, f2, n_lines))
    args = (n1, n2, lines, M.neighborhood_delta(n1), M.neighborhood_delta(n2))
    before = IK.launches
    got = IK.intersect_stage1_pair_pts(*args)
    assert IK.launches == before + 1
    ref = IK.intersect_stage1_pair_pts_reference(*args)
    assert int(ref[0].sum()) > 0
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_resample_kernel_matches_plain(cuda_device):
    v1 = torch.tensor(_cloud(800, 3), device=cuda_device)
    v2 = torch.tensor(_cloud(800, 4), device=cuda_device) + 0.1
    fv = RS.prep_faces(G.bbox_face_vertices(v1[None])[0],
                       G.bbox_face_vertices(v2[None])[0])
    r, center = torch.tensor(2.2, device=cuda_device), v2.mean(0)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for C in (200_000, 777):
        u4 = torch.rand((4, C), generator=g, device=cuda_device)
        before = RS.launches
        cand, ok = RS.sample_and_hit(u4, r, center, fv)
        assert RS.launches == before + 1
        cand_r, ok_r = RS.sample_and_hit_reference(u4, r, center, fv)
        assert float((cand - cand_r).abs().max()) <= 1e-4
        assert float((ok != ok_r).float().mean()) <= 1e-3
        acc, acc_r = float(ok.float().mean()), float(ok_r.float().mean())
        assert acc_r > 0.01
        assert abs(acc - acc_r) <= 0.1 * acc_r


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_input_they_cannot_take(cuda_device):
    """A CUDA tensor goes to the kernel or raises: no fallback."""
    x = torch.zeros((4, 12), device=cuda_device)  # nnei = 4: not the kernel's
    lines = torch.zeros((3, 6), device=cuda_device)
    d = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError):
        IK.intersect_stage1_pair_pts(x, x, lines, d, d)
    fv = torch.zeros((24, 16), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError):
        RS.sample_and_hit(torch.zeros((4, 8), device=cuda_device), 1.0,
                          torch.zeros(3, device=cuda_device), fv)


@pytest.mark.cuda
def test_classical_step_on_card(cuda_device):
    """Three epochs of make_step on the card launch each kernel three times
    and stay finite; the metric on the card agrees with the CPU's plain
    path on the same lines."""
    v1, v2 = _cloud(1200, 5), _cloud(1200, 6)
    cfg = TC.ClassicalConfig(n_lines=2000, num_sample=512)
    data = TC.prepare_pair(v1, v2, cfg, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = TC.init_twist(g)
    carry = (params, TC.init_adam(params), data["src"])
    step = TC.make_step(cfg, data)
    rs0, ik0 = RS.launches, IK.launches
    for _ in range(3):
        carry, m = step(carry, torch.rand((4, LN.ROUNDS * cfg.n_lines),
                                          generator=g, device=cuda_device))
        assert bool(m["valid"]) and bool(torch.isfinite(m["loss"]))
    assert (RS.launches - rs0, IK.launches - ik0) == (3, 3)

    u4 = torch.rand((4, LN.ROUNDS * cfg.n_lines), generator=g, device=cuda_device)
    lines = LN.resample_lines(u4, data["radius"], data["center"], cfg.n_lines,
                              carry[2], data["tar"])
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        p = carry[0].detach().to(dev).requires_grad_(True)
        R, t = se3.exp3(p)
        loss, valid = M.intersection_loss_rigid(
            R, t, data["neis_src"].to(dev), data["neis_tar"].to(dev), lines.to(dev))
        (grad,) = torch.autograd.grad(loss, p)
        assert bool(valid)
        out.append((float(loss.detach()), grad.cpu().numpy()))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    assert np.linalg.norm(gk - gp) <= 5e-4 * np.linalg.norm(gp)


@pytest.mark.cuda
def test_run_and_register_on_card(cuda_device, tmp_path):
    """``run`` and the register CLI on the card: finite history of the
    right length, the callback once per block, a finite 3x4 transform."""
    from a_robust_registration_loss_tpu_torch import register
    from a_robust_registration_loss_tpu_torch.data import objio

    v1, v2 = _cloud(1000, 7), _cloud(1000, 8)
    fired = []
    cfg = TC.ClassicalConfig(n_epochs=6, n_lines=1000, num_sample=256, log_every=4)
    params, hist = TC.run(v1, v2, cfg, device=cuda_device,
                          callback=lambda e, p, m, s: fired.append(e))
    assert params.device.type == "cuda" and fired == [4, 6]
    assert hist["loss"].shape == (6,) and np.isfinite(hist["loss"]).all()
    assert hist["valid"].all()

    src, tar = str(tmp_path / "src.obj"), str(tmp_path / "tar.obj")
    objio.write_obj(src, v1)
    objio.write_obj(tar, v2)
    out = str(tmp_path / "T.txt")
    register.main([src, tar, "--out", out, "--n_epochs", "5", "--n_lines", "1000",
                   "--num_sample", "256"])
    T = np.loadtxt(out)
    assert T.shape == (3, 4) and np.isfinite(T).all()
