"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel has
no CPU mode. The file imports no JAX, so it also runs where only PyTorch is
installed; the suite's conftest.py imports JAX, hence ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Bars: stage 1 in every mode, one or two clouds, unbatched and batched:
counts, slot indices, d2, recon and slot coordinates exactly equal (both
sides round every operation on its own), and a batched launch equal to B
single launches; the rate probe exactly equal to its plain version; the
resampler's candidates and labels exactly equal to its plain version (the
kernel keeps every face test's arithmetic), on random draws and on
``adversarial_cases``, with the acceptance rate also within 10% (the bar
the JAX package holds its own two resampler paths to); each wrapper call
counts one launch; the metrics on
the card (rigid, batched generic, the trainers' batched rigid glue) within
1e-4 relative (loss) and 5e-4 relative L2 (gradient) of the plain path on
the CPU; a batched resampler launch equal to B single launches bit for bit;
the row gather's forward equal to its plain version and, in range, to
``take_along_dim`` bit for bit at widths 1 to 8 and 128, ragged Q and a
table one float off 16-byte alignment, its
backward equal to the plain version on the CPU bit for bit (both sum in
ascending q), within 1e-6 x sum |g| of the plain version on the card
(atomics, in an order of their own) and equal between two launches, the
backward's sort equal to its plain version exactly, all of it also with
every query on one row, most rows empty, indices out of range and Q no
multiple of any chunk; stage 1's split into face segments exact at ragged F
and L, F below the segment count, kmax = 1 and a line whose first segment
alone holds more than kmax hits; DCP's
evaluation on the card with one resampler and one stage-1 launch per batch
and the CPU path's R_ab and t_ab within 1e-4.
"""

import numpy as np
import pytest
import torch

from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.models import dcp as D
from a_robust_registration_loss_tpu_torch.ops.cuda import gather as GK
from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
from a_robust_registration_loss_tpu_torch.ops.cuda import probe as PB
from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
from a_robust_registration_loss_tpu_torch.se3 import se3
from a_robust_registration_loss_tpu_torch.train import classical as TC
from a_robust_registration_loss_tpu_torch.train import dcp as TD
from a_robust_registration_loss_tpu_torch.train import losses as LS

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
    kw = dict(emit_d2=False, emit_recon=False, emit_pts=True)
    key = IK.instantiation(2, **kw)
    before = IK.launches[key]
    got = IK.stage1(args[:2], args[2], args[3:], **kw)
    assert IK.launches[key] == before + 1
    ref = IK.stage1_reference(args[:2], args[2], args[3:], **kw)
    assert int(ref[0].sum()) > 0
    for g, r in zip(got, ref):
        assert (g is None and r is None) or torch.equal(g, r)


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
        before = (RS.launches["single"], RS.launches["batched"])
        cand, ok = RS.sample_and_hit(u4, r, center, fv)
        assert (RS.launches["single"], RS.launches["batched"]) == (before[0] + 1, before[1])
        cand_r, ok_r = RS.sample_and_hit_reference(u4, r, center, fv)
        assert torch.equal(cand, cand_r)
        assert torch.equal(ok, ok_r)
        acc, acc_r = float(ok.float().mean()), float(ok_r.float().mean())
        assert acc_r > 0.01
        assert abs(acc - acc_r) <= 0.1 * acc_r


@pytest.mark.cuda
@pytest.mark.parametrize("case", RS.ADVERSARIAL_CASES)
def test_resample_kernel_adversarial(cuda_device, case):
    """The knife-edge candidate sets: one launch equal to the plain version
    bit for bit, and a batched launch equal to its single launches."""
    u4, r, c, f1, f2 = RS.adversarial_cases(cuda_device)[case]
    fv = RS.prep_faces(f1, f2)
    key = "batched" if u4.dim() == 3 else "single"
    before = RS.launches[key]
    cand, ok = RS.sample_and_hit(u4, r, c, fv)
    assert RS.launches[key] == before + 1
    cand_r, ok_r = RS.sample_and_hit_reference(u4, r, c, fv)
    assert torch.equal(cand, cand_r) and torch.equal(ok, ok_r)
    for b in range(u4.shape[0] if key == "batched" else 0):
        one = RS.sample_and_hit(u4[b], r[b], c[b], fv[b])
        assert torch.equal(cand[b], one[0]) and torch.equal(ok[b], one[1])


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_input_they_cannot_take(cuda_device):
    """A CUDA tensor goes to the kernel or raises: no fallback."""
    x = torch.zeros((4, 12), device=cuda_device)  # nnei = 4: not the kernel's
    lines = torch.zeros((3, 6), device=cuda_device)
    d = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError):
        IK.stage1((x, x), lines, (d, d), emit_d2=False, emit_recon=False, emit_pts=True)
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
    pts = IK.instantiation(2, False, False, True)
    rs0, ik0, all0 = RS.launches["single"], IK.launches[pts], sum(IK.launches.values())
    for _ in range(3):
        carry, m = step(carry, torch.rand((4, LN.ROUNDS * cfg.n_lines),
                                          generator=g, device=cuda_device))
        assert bool(m["valid"]) and bool(torch.isfinite(m["loss"]))
    assert (RS.launches["single"] - rs0, IK.launches[pts] - ik0) == (3, 3)
    assert sum(IK.launches.values()) - all0 == 3

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


MODES = [(d2, recon, pts) for d2 in (False, True) for recon in (False, True)
         for pts in (False, True)]


def _batch(B, f1, f2, n_lines):
    """B problems of one shape, stacked on the CPU."""
    probs = [_problem(f1, f2, n_lines, seed=10 + b) for b in range(B)]
    return tuple(torch.stack([p[k] for p in probs]) for k in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("flags", MODES, ids=lambda f: "d2%d-recon%d-pts%d" % f)
def test_stage1_modes_match_plain(cuda_device, flags, batched):
    """Every mode, one and two clouds: the kernel's outputs equal the plain
    version's bit for bit, one launch per call, counted under its
    instantiation alone."""
    n1, n2, lines = _batch(3, 200, 170, 300) if batched else _problem(333, 301, 257)
    n1, n2, lines = (x.to(cuda_device) for x in (n1, n2, lines))
    d1, d2 = M.neighborhood_delta(n1), M.neighborhood_delta(n2)
    for neis, deltas in (((n1,), (d1,)), ((n1, n2), (d1, d2))):
        before = dict(IK.launches)
        got = IK.stage1(neis, lines, deltas, emit_d2=flags[0], emit_recon=flags[1],
                        emit_pts=flags[2])
        key = IK.instantiation(len(neis), *flags)
        assert IK.launches[key] == before.get(key, 0) + 1
        assert all(IK.launches[k] == n for k, n in before.items() if k != key)
        ref = IK.stage1_reference(neis, lines, deltas, emit_d2=flags[0],
                                  emit_recon=flags[1], emit_pts=flags[2])
        assert int(ref[0].sum()) > 0
        for g, r in zip(got, ref):
            assert (g is None and r is None) or torch.equal(g, r)


@pytest.mark.cuda
def test_stage1_batch_equals_single_launches(cuda_device):
    n1, n2, lines = (x.to(cuda_device) for x in _batch(4, 300, 280, 1000))
    d1, d2 = M.neighborhood_delta(n1), M.neighborhood_delta(n2)
    kw = dict(emit_d2=True, emit_recon=True, emit_pts=True)
    got = IK.stage1((n1, n2), lines, (d1, d2), **kw)
    for b in range(4):
        one = IK.stage1((n1[b], n2[b]), lines[b], (d1[b], d2[b]), **kw)
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)


def _dense_first_faces(neis, lines, copies=6):
    """Make the first ``copies`` faces one equilateral triangle of side 0.2
    and send every line through its centroid: each line then hits all of
    them, whatever its direction (its vertices lie 0.115 from the centroid,
    under the threshold 0.8655 * 0.2)."""
    c = torch.tensor([0.3, -0.2, 0.6])
    tri = c + 0.2 / 3**0.5 * torch.tensor([[1.0, 0.0, 0.0], [-0.5, 0.75**0.5, 0.0],
                                           [-0.5, -(0.75**0.5), 0.0]])
    neis, lines = neis.clone(), lines.clone()
    neis[..., :copies, :] = tri.reshape(9)
    lines[..., 3:] = c
    return neis, lines


# (batch, F1, F2, L, kmax, dense)
STAGE1_SEGMENT_CASES = {
    "ragged": (None, 333, 301, 257, 4, False),
    "kmax1": (None, 333, 301, 257, 1, False),
    "few-faces": (None, 3, 2, 100, 4, False),
    "dense-first-segment": (None, 333, 301, 257, 4, True),
    "one-line": (None, 70, 65, 1, 4, False),
    "batched": (16, 150, 131, 8500, 4, False),
    "batched-dense-first-segment": (16, 150, 131, 8500, 2, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STAGE1_SEGMENT_CASES))
def test_stage1_segments_match_plain(cuda_device, case):
    """The kernel's split of the faces into segments and their merge give
    the plain version's outputs bit for bit, every mode on, one launch."""
    B, f1, f2, L, kmax, dense = STAGE1_SEGMENT_CASES[case]
    n1, n2, lines = _problem(max(f1, 3), max(f2, 3), min(L, 2000))
    n1, n2 = n1[:f1], n2[:f2]
    lines = lines[torch.arange(L) % lines.shape[0]]
    if B:
        shift = 0.01 * torch.arange(B)[:, None, None]
        origins = lines[None, :, 3:] + shift  # the samples differ; directions stay unit
        lines = torch.cat([lines[None, :, :3].expand(B, L, 3), origins], -1)
        n1, n2 = n1[None] + shift, n2[None] + shift
    if dense:
        n1, lines = _dense_first_faces(n1, lines)
    n1, n2, lines = (x.to(cuda_device) for x in (n1, n2, lines))
    deltas = (M.neighborhood_delta(n1), M.neighborhood_delta(n2))
    kw = dict(emit_d2=True, emit_recon=True, emit_pts=True)
    before = sum(IK.launches.values())
    got = IK.stage1((n1, n2), lines, deltas, kmax, **kw)
    assert sum(IK.launches.values()) == before + 1
    ref = IK.stage1_reference((n1, n2), lines, deltas, kmax, **kw)
    if dense:  # cloud 0's first faces alone overflow the slots of every line
        assert int(ref[0].select(-2, 0).min()) > kmax
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 2, 5])
def test_probe_matches_plain(cuda_device, iters):
    x = torch.rand(10_000, generator=torch.Generator().manual_seed(iters)) * 0.6 + 0.05
    x = x.to(cuda_device)
    before = PB.launches
    got = PB.logistic_map(x, iters)
    assert PB.launches == before + 1
    assert torch.equal(got, PB.logistic_map_reference(x, iters))


@pytest.mark.cuda
def test_probe_measures_a_rate(cuda_device):
    rate, ms = PB.measured_fp32_rate(cuda_device)
    assert rate > 0 and ms > 0


@pytest.mark.cuda
def test_generic_metric_and_glue_on_card(cuda_device):
    """find_intersections, intersection_loss_batch (forward and gradient)
    and _metric_batch_rt on the card: one stage-1 launch each, and the CPU
    plain path's values and gradients."""
    n1, n2, lines = _batch(3, 300, 280, 1000)
    R = torch.stack([se3.exp3(torch.tensor([0.02 * b, -0.01, 0.03, 0.01, 0.0, -0.02]))[0]
                     for b in range(3)])
    t = torch.tensor([[0.01, 0.0, -0.02]] * 3)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        a = n1.to(dev).requires_grad_(True)
        before = dict(IK.launches)
        inter = M.find_intersections(a, lines.to(dev))
        losses, valid = M.intersection_loss_batch(a, n2.to(dev), lines.to(dev))
        (g,) = torch.autograd.grad(torch.where(valid, losses, 0.0).mean(), a)
        Rd, td = R.to(dev).requires_grad_(True), t.to(dev).requires_grad_(True)
        per = LS._metric_batch_rt(Rd, td, n1.to(dev), n2.to(dev), lines.to(dev), LS.LossConfig())
        gR, gt = torch.autograd.grad(per.sum(), (Rd, td))
        if dev.type == "cuda":  # d2 single cloud once, pts pair twice
            d2, pts = IK.instantiation(1, True, False, False), IK.instantiation(2, False, False, True)
            assert {k: n - before.get(k, 0) for k, n in IK.launches.items()
                    if n != before.get(k, 0)} == {d2: 1, pts: 2}
        assert bool(valid.all()) and bool((per > 0).all())
        out[dev.type] = (inter.count.cpu(), losses.detach().cpu().numpy(), g.cpu().numpy(),
                         per.detach().cpu().numpy(),
                         np.concatenate([gR.cpu().numpy().ravel(), gt.cpu().numpy().ravel()]))
    (ck, lk, gk, pk, grk), (cp, lp, gp, pp, grp) = out["cuda"], out["cpu"]
    assert torch.equal(ck, cp)
    np.testing.assert_allclose(lk, lp, rtol=1e-4)
    np.testing.assert_allclose(pk, pp, rtol=1e-4)
    assert np.linalg.norm(gk - gp) <= 5e-4 * np.linalg.norm(gp)
    assert np.linalg.norm(grk - grp) <= 5e-4 * np.linalg.norm(grp)


@pytest.mark.cuda
def test_batched_wrappers_raise_on_what_they_cannot_take(cuda_device):
    lines = torch.zeros((2, 5, 6), device=cuda_device)
    n = torch.zeros((3, 4, 9), device=cuda_device)  # batch 3 against 2
    with pytest.raises(ValueError):
        IK.intersect_stage1(n, lines, torch.zeros((3, 4), device=cuda_device))
    with pytest.raises(ValueError):
        IK.intersect_stage1(n[:2], lines, torch.zeros((2, 5), device=cuda_device))
    with pytest.raises(ValueError):
        PB.logistic_map(torch.ones(8, device=cuda_device), -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("shape", [(2, 40, 6, 100), (1, 128, 3, 128), (3, 17, 5, 33),
                                   (2, 1000, 128, 5000), (2, 300, 260, 777)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gather_kernels_match_plain(cuda_device, shape, dtype):
    """Forward, backward and the autograd path, with indices out of range
    on both sides; one launch per call."""
    B, N, C, Q = shape
    g = torch.Generator().manual_seed(0)
    table = torch.randn((B, N, C), generator=g).to(cuda_device)
    up = torch.randn((B, Q, C), generator=g).to(cuda_device)
    idx = torch.randint(-2, N + 2, (B, Q), generator=g, dtype=dtype).to(cuda_device)
    before = dict(GK.launches)
    leaf = table.clone().requires_grad_(True)
    out = GK.gather_rows(leaf, idx)
    (grad,) = torch.autograd.grad(out, leaf, up)
    assert GK.launches == {k: n + 1 for k, n in before.items()}  # forward, sort, sum
    assert torch.equal(out.detach(), GK.gather_rows_reference(table, idx))
    bad = (idx < 0) | (idx >= N)
    assert bool(bad.any()) and bool((out.detach()[bad] == 0).all())
    assert torch.equal(grad, GK.gather_rows_bwd(up, idx, N))  # two launches, equal bits
    assert torch.equal(grad.cpu(), GK.gather_rows_bwd_reference(up.cpu(), idx.cpu(), N))
    ref = GK.gather_rows_bwd_reference(up, idx, N)
    tol = 1e-6 * GK.gather_rows_bwd_reference(up.abs(), idx, N)
    assert bool(((grad - ref).abs() <= tol).all())
    inside = idx.clamp(0, N - 1)
    assert torch.equal(GK.gather_rows_fwd(table, inside),
                       torch.take_along_dim(table, inside.long()[..., None], 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("C", [1, 2, 3, 5, 6, 7, 8, 128])
def test_gather_forward_widths(cuda_device, C, dtype):
    """The forward at every narrow width and C = 128, Q no multiple of 32,
    a batch whose runs of queries straddle two samples, indices out of
    range; then the same table one float off 16-byte alignment (the rows
    kernel at C = 4 and 8 too). Equal to the plain version bit for bit,
    and to take_along_dim in range; one launch a call."""
    B, N, Q = 3, 300, 1001
    g = torch.Generator().manual_seed(C)
    flat = torch.randn(B * N * C + 1, generator=g).to(cuda_device)
    idx = torch.randint(-3, N + 3, (B, Q), generator=g, dtype=dtype).to(cuda_device)
    inside = idx.clamp(0, N - 1)
    for table in (flat[:-1].view(B, N, C), flat[1:].view(B, N, C)):
        before = GK.launches["fwd"]
        out = GK.gather_rows_fwd(table, idx)
        assert GK.launches["fwd"] == before + 1
        assert torch.equal(out, GK.gather_rows_reference(table, idx))
        bad = (idx < 0) | (idx >= N)
        assert bool(bad.any()) and bool((out[bad] == 0).all())
        assert torch.equal(GK.gather_rows_fwd(table, inside),
                           torch.take_along_dim(table, inside.long()[..., None], 1))


def _gather_edge_case(case, dtype):
    """(g, idx, N) on the CPU for the backward's edge cases."""
    gen = torch.Generator().manual_seed(3)
    B, N, C, Q = {"one-row": (2, 300, 6, 5001), "sparse-rows": (3, 2000, 3, 777),
                  "out-of-range": (2, 64, 5, 4099), "all-dropped": (1, 9, 4, 130),
                  "wide": (2, 1024, 128, 3001), "one-query": (2, 7, 3, 1)}[case]
    g = torch.randn((B, Q, C), generator=gen)
    if case == "one-row":
        idx = torch.full((B, Q), 123, dtype=dtype)
    elif case == "sparse-rows":  # 5 of the 2,000 rows take every query
        idx = torch.tensor([3, 700, 701, 1500, 1999])[torch.randint(0, 5, (B, Q), generator=gen)]
    elif case == "out-of-range":
        idx = torch.randint(-40, N + 40, (B, Q), generator=gen)
    elif case == "all-dropped":
        idx = torch.where(torch.rand((B, Q), generator=gen) < 0.5, -1, N)
    else:
        idx = torch.randint(0, N, (B, Q), generator=gen)
    return g, idx.to(dtype), N


GATHER_EDGE_CASES = ["one-row", "sparse-rows", "out-of-range", "all-dropped", "wide", "one-query"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("case", GATHER_EDGE_CASES)
def test_gather_backward_edge_cases(cuda_device, case, dtype):
    """The sort equals its plain version exactly, the sum and the whole
    backward equal the CPU's plain version bit for bit, twice."""
    g, idx, N = _gather_edge_case(case, dtype)
    before = dict(GK.launches)
    start, perm = GK.sort_by_row(idx.to(cuda_device), N)
    want_start, want_perm = GK.sort_by_row_reference(idx, N)
    assert torch.equal(start.cpu(), want_start) and torch.equal(perm.cpu(), want_perm)
    want = GK.gather_rows_bwd_reference(g, idx, N)
    assert torch.equal(GK.segmented_sum(g.to(cuda_device), start, perm).cpu(), want)
    assert GK.launches == {"fwd": before["fwd"], "bwd_sort": before["bwd_sort"] + 1,
                           "bwd_sum": before["bwd_sum"] + 1}
    for _ in range(2):
        got = GK.gather_rows_bwd(g.to(cuda_device), idx.to(cuda_device), N)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_gather_backward_takes_many_rows_or_raises(cuda_device):
    """A table of 12,000 rows leaves the sort 2 warps a block and still
    sorts; one of 60,000 rows is refused."""
    gen = torch.Generator().manual_seed(5)
    N, Q = 12_000, 20_000
    assert GK._sort_plan(N, Q)[1] == 2
    g = torch.randn((1, Q, 3), generator=gen)
    idx = torch.randint(-5, N + 5, (1, Q), generator=gen)
    got = GK.gather_rows_bwd(g.to(cuda_device), idx.to(cuda_device), N)
    assert torch.equal(got.cpu(), GK.gather_rows_bwd_reference(g, idx, N))
    with pytest.raises(ValueError, match="table rows"):
        GK.gather_rows_bwd(g.to(cuda_device), idx.to(cuda_device), 60_000)


@pytest.mark.cuda
def test_gather_raises_on_cuda_input_it_cannot_take(cuda_device):
    table = torch.zeros((2, 8, 4), device=cuda_device)
    idx = torch.zeros((2, 5), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        GK.gather_rows(table.double(), idx)
    with pytest.raises(ValueError):
        GK.gather_rows(table, idx.cpu())
    with pytest.raises(ValueError):
        GK.gather_rows_bwd(torch.zeros((2, 6, 4), device=cuda_device), idx, 8)


@pytest.mark.cuda
def test_batched_resampler_equals_single_launches(cuda_device):
    """One launch for B samples, each with its own uniforms, sphere and
    boxes, equals B single launches bit for bit; batch_lines makes one."""
    B, n = 3, 4000
    v1 = torch.stack([torch.tensor(_cloud(700, 20 + b)) for b in range(B)]).to(cuda_device)
    v2 = torch.stack([torch.tensor(_cloud(700, 30 + b)) for b in range(B)]).to(cuda_device) + 0.05
    g = torch.Generator(device=cuda_device).manual_seed(1)
    u4 = torch.rand((B, 4, LN.ROUNDS * n), generator=g, device=cuda_device)
    fv = RS.prep_faces(G.bbox_face_vertices(v1), G.bbox_face_vertices(v2))
    r = torch.tensor([2.2, 1.8, 2.6], device=cuda_device)
    c = v2.mean(1)
    before = (RS.launches["single"], RS.launches["batched"])
    cand, ok = RS.sample_and_hit(u4, r, c, fv)
    assert (RS.launches["single"], RS.launches["batched"]) == (before[0], before[1] + 1)
    for b in range(B):
        cand_b, ok_b = RS.sample_and_hit(u4[b], r[b], c[b], fv[b])
        assert torch.equal(cand[b], cand_b) and torch.equal(ok[b], ok_b)
    assert (RS.launches["single"], RS.launches["batched"]) == (before[0] + B, before[1] + 1)
    box = G.bounding_box_corners(v2)
    lines = LS.batch_lines(u4, box, c, n, v1, v2, radius_scale=0.5)
    assert (RS.launches["single"], RS.launches["batched"]) == (before[0] + B, before[1] + 2)
    assert lines.shape == (B, n, 6)
    radius = 0.5 * torch.linalg.vector_norm(box[:, 0] - box[:, -1], dim=-1)
    for b in range(B):
        assert torch.equal(lines[b], LN.resample_lines(u4[b], radius[b], c[b], n, v1[b], v2[b]))
    with pytest.raises(ValueError):
        RS.sample_and_hit(u4, r[:2], c, fv)


def _dcp_batch(B, N, F, seed):
    """A DCP batch on the CPU: two noisy ellipsoids related by a rotation
    about z and a translation, column convention."""
    rng = np.random.default_rng(seed)
    src = torch.stack([torch.tensor(_cloud(N, seed + b)) for b in range(B)])
    a = 0.2
    R = torch.tensor([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                     dtype=torch.float32)
    T = torch.tensor(rng.uniform(-0.05, 0.05, 3), dtype=torch.float32)
    tar = src @ R + T
    tar = tar - tar.mean(1, keepdim=True)
    src = src - src.mean(1, keepdim=True)
    rep = lambda x: x[None].repeat(B, *[1] * x.dim())
    return {"points_src_sample": src, "points_tar_sample": tar,
            "points_based_neighs_src": G.sample_neighs(src, F, 3),
            "points_based_neighs_tar": G.sample_neighs(tar, F, 3),
            "tar_box": G.bounding_box_corners(tar), "centers": tar.mean(1),
            "R": rep(R.T.contiguous()), "T": rep(T), "R_inv": rep(R), "T_inv": rep(-R @ T)}


@pytest.mark.cuda
def test_dcp_evaluate_on_card(cuda_device, tmp_path):
    """evaluate on the card: one resampler and one stage-1 launch per
    batch, finite metrics, Eval.json and the OBJ dumps; the network on the
    card agrees with the CPU path; the gradient of dcp_train_loss reaches
    every parameter."""
    cfg = TD.DCPTrainConfig(loss=LS.LossConfig(n_lines=2000),
                            model=D.DCPConfig(emb_dims=64, ff_dims=128, dgcnn_k=8))
    model = D.DCP(cfg.model)
    D.reset_parameters(model, torch.Generator().manual_seed(0))
    loader = [_dcp_batch(2, 256, 128, seed) for seed in (40, 50)]
    pts = IK.instantiation(2, False, False, True)
    before = (RS.launches["batched"], IK.launches[pts], sum(IK.launches.values()))
    summary = TD.evaluate(cfg, model.state_dict(), loader, str(tmp_path), log=lambda m: None)
    after = (RS.launches["batched"], IK.launches[pts], sum(IK.launches.values()))
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2)
    assert all(np.isfinite(v) for v in summary.values()) and summary["loss_intersection"] > 0
    assert (tmp_path / "Eval.json").exists() and (tmp_path / "0_3src_gt.obj").exists()

    batch = {k: v.to(cuda_device) for k, v in loader[0].items()}
    with torch.no_grad():
        R_c, t_c = TD.forward(model, loader[0])[:2]
    model.to(cuda_device)
    out = TD.forward(model, batch)
    assert float((out[0].detach().cpu() - R_c).abs().max()) <= 1e-4
    assert float((out[1].detach().cpu() - t_c).abs().max()) <= 1e-4
    g = torch.Generator(device=cuda_device).manual_seed(2)
    loss, mon = LS.dcp_train_loss(batch, *out, cfg.loss, generator=g)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert float(loss) > 0 and all(bool(torch.isfinite(x).all()) for x in grads)
    assert sum(float(x.abs().sum()) for x in grads) > 0
