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
and the CPU path's R_ab and t_ab within 1e-4; FMR's training step with one
batched resampler and three stage-1 launches, on the same iterates and
lines the loss within 1e-4 relative and its gradient to the iterates
within 5e-4 relative L2 of the CPU's plain path; the dataset cached on the
card (and prefetched to it) equal to the streaming loader bit for bit;
RPM-Net's ball query on the card equal to the CPU's except in rows with a
pair whose float64 d^2 lies within 1e-6 r^2 of r^2, the gather on its
indices equal to ``gather_rows_reference`` and ``take_along_dim`` bit for
bit with one forward launch and no backward, and a forward of the model
launching one gather a feature pass; each model's bf16 forward on the card
against the CPU's bf16 forward on the same weights (and, for RPM-Net, the
card's ball indices): fp32 outputs, transforms within 0.05 and FMR's
``loss_ende`` within 5% relative (bf16 rounding that falls the other way
where the two sides sum in other orders: the bars of ``chip_smoke.py``'s
bf16 phases); and every kernel wrapper refusing a bf16 input rather than
casting it; and two ranks sharing the card over gloo under (1, 2): each
rank's stage-1 launches sweep its L/2 lines, the metric's values equal the
one-process values on the card bit for bit and its gradient within 1e-5
relative L2, and one classical step's loss and twists within 1e-6; the
classical step's CUDA graph (``train/graphs.py``) equal to the eager loop
bit for bit over 10 epochs, its launch counters counting per replay, and
three DCP train steps through the scanned epoch's graphs equal to three
eager steps bit for bit.
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


def _fmr_batch(B, N, F, seed):
    """``_dcp_batch`` in the FMR form: row-convention R and T, igt."""
    b = _dcp_batch(B, N, F, seed)
    R = b["R"].transpose(-1, -2).contiguous()
    igt = torch.eye(4).repeat(B, 1, 1)
    igt[:, :3, :3] = R
    igt[:, :3, 3] = -torch.einsum("bij,bj->bi", R, b["T"])
    b.update(R=R, R_inv=R.transpose(-1, -2).contiguous(), igt=igt)
    return b


@pytest.mark.cuda
def test_fmr_kernel_path_on_card(cuda_device):
    """FMR's training step on the card launches one batched resampler and
    three stage-1 kernels; on the same iterates and lines the card's loss is
    within 1e-4 relative of the CPU's plain path, its gradient to the
    iterates within 5e-4 relative L2, and the solver's iterates within
    5e-3."""
    from a_robust_registration_loss_tpu_torch.models.fmr import FMRConfig, SolveRegistration
    from a_robust_registration_loss_tpu_torch.train import fmr as TF
    from a_robust_registration_loss_tpu_torch.train import harness as H

    cfg = TF.FMRTrainConfig(loss=LS.LossConfig(n_lines=2000),
                            model=FMRConfig(dim_k=128, num_points=256))
    model = TF.init_model(cfg, 0, device=cuda_device)
    batch = {k: v.to(cuda_device) for k, v in _fmr_batch(2, 256, 128, 60).items()}
    pts = IK.instantiation(2, False, False, True)
    before = (RS.launches["batched"], IK.launches[pts], sum(IK.launches.values()))
    g = torch.Generator(device=cuda_device).manual_seed(3)
    state, m = TF.train_step(model, H.adam_init(model.parameters()), batch, cfg, generator=g)
    after = (RS.launches["batched"], IK.launches[pts], sum(IK.launches.values()))
    assert tuple(a - b for a, b in zip(after, before)) == (1, 3, 3)
    assert float(m["nonfinite_steps"]) == 0.0 and float(m["loss_intersection"]) > 0

    cpu = SolveRegistration(cfg.model)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        gk = TF.forward(model, batch, 5)["g_series"]
        gc = TF.forward(cpu, {k: v.cpu() for k, v in batch.items()}, 5)["g_series"]
    assert float((gk.cpu() - gc).abs().max()) <= 5e-3
    u4 = LS.draw_uniforms(2, 2000, cuda_device, g)
    out = {}
    for dev in (cuda_device, "cpu"):
        b = {k: v.to(dev) for k, v in batch.items()}
        gs = gk.to(dev).clone().requires_grad_(True)
        total, _ = LS.fmr_train_loss(gs, torch.zeros((), device=dev), b, cfg.loss, 5,
                                     u4=u4.to(dev))
        (dg,) = torch.autograd.grad(total, gs)
        out[str(dev)] = (float(total), dg.cpu().double())
    (lk, dk), (lc, dc) = out[str(cuda_device)], out["cpu"]
    assert abs(lk - lc) <= 1e-4 * abs(lc)
    assert float((dk - dc).norm() / dc.norm()) <= 5e-4


@pytest.mark.cuda
def test_device_cache_on_card(cuda_device, tmp_path):
    """The dataset cached on the card: batches already there, equal to the
    streaming Loader's bit for bit, and a prefetched batch equal too."""
    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.data import make_dataset as MK
    from a_robust_registration_loss_tpu_torch.data import objio

    objio.write_obj(str(tmp_path / "base.obj"), _cloud(400, 1))
    MK.build([str(tmp_path / "base.obj")], str(tmp_path / "d"), n_views=4, num_points=128,
             rot_mag=30.0, trans_mag=0.2, num_sample=64, indexed=True, log=lambda *a: None)
    train, _ = DS.generate_datasets(DS.DatasetConfig(data_path=str(tmp_path / "d"), n=4,
                                                     train_batch=2, fmr=True))
    cache = DS.maybe_device_cache(train, device=cuda_device)
    assert isinstance(cache, DS.DeviceCache)
    pre = DS.PrefetchLoader(train, device=cuda_device)
    for epoch in range(2):
        cache.set_epoch(epoch)
        train.set_epoch(epoch)
        want = list(train)
        pre.set_epoch(epoch)
        for got in (list(cache), list(pre)):
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                assert all(a[k].is_cuda and torch.equal(a[k].cpu(), torch.from_numpy(b[k]))
                           for k in b)


def _knife_edge_rows(xyz, radius):
    """(B, N) bool: rows with a pair (other than the point itself) whose
    float64 d^2 lies within 1e-6 r^2 of r^2."""
    p = xyz.double()
    d2 = ((p[:, :, None] - p[:, None]) ** 2).sum(-1)
    edge = (d2 - radius**2).abs() <= 1e-6 * radius**2
    edge &= ~torch.eye(p.shape[1], dtype=torch.bool)[None]
    return edge.any(-1)


@pytest.mark.cuda
def test_rpm_ball_query_and_gather_on_card(cuda_device):
    """RPM-Net's grouping at its default radius and 64 neighbours: the ball
    query on the card against the CPU (exact off the knife edge), then the
    gather on those indices against its plain version and take_along_dim,
    bit for bit, one forward launch and no backward; a forward of the model
    launches one gather a feature pass (2 an iteration)."""
    from a_robust_registration_loss_tpu_torch.models import rpmnet as R

    B, N, ns, r = 2, 1024, 64, 0.3
    xyz = torch.stack([torch.tensor(_cloud(N, s)) for s in range(B)])
    normals = torch.nn.functional.normalize(xyz, dim=-1)
    itself = torch.arange(N).expand(B, N)
    cpu = R.query_ball_point_excl(r, ns, xyz, xyz, itself)
    xyz_d = xyz.to(cuda_device)
    card = R.query_ball_point_excl(r, ns, xyz_d, xyz_d, itself.to(cuda_device)).cpu()
    edge = _knife_edge_rows(xyz, r)
    assert torch.equal(card[~edge], cpu[~edge]) and (~edge).sum() > B * N // 2
    table = torch.cat([xyz, normals], -1).to(cuda_device)
    idx = card.to(cuda_device).reshape(B, N * ns)
    before = dict(GK.launches)
    out = GK.gather_rows(table, idx)
    assert GK.launches["fwd"] - before["fwd"] == 1
    assert GK.launches["bwd_sum"] == before["bwd_sum"]
    assert torch.equal(out, GK.gather_rows_reference(table, idx))
    assert torch.equal(out, torch.take_along_dim(table, idx[..., None], 1))

    model = R.RPMNetEarlyFusion(R.RPMNetConfig(feat_dim=32)).to(cuda_device)
    before = dict(GK.launches)
    transforms, _ = model(xyz_d, normals.to(cuda_device), xyz_d, normals.to(cuda_device),
                          num_iter=2)
    sum(t.sum() for t in transforms).backward()
    assert GK.launches["fwd"] - before["fwd"] == 4
    assert GK.launches["bwd_sum"] == before["bwd_sum"] and GK.launches["bwd_sort"] == before[
        "bwd_sort"]


def _bf16_case(name, device):
    """A bf16 model of each trainer at a small width (random weights from
    seed 0) and its inputs, on ``device``."""
    from a_robust_registration_loss_tpu_torch.models import fmr as F
    from a_robust_registration_loss_tpu_torch.models import rpmnet as R

    torch.manual_seed(0)
    xyz = torch.stack([torch.tensor(_cloud(256, s)) for s in range(2)])
    tgt = xyz @ se3.exp(torch.tensor([0.1, -0.2, 0.15, 0.02, 0.0, -0.03]))[:3, :3].T
    if name == "dcp":
        m = D.DCP(D.DCPConfig(emb_nn="pointnet", emb_dims=64, ff_dims=64, dtype="bfloat16"))
        args = (xyz, tgt)
    elif name == "fmr":
        m = F.SolveRegistration(F.FMRConfig(dim_k=64, num_points=256, dtype="bfloat16"))
        args = (tgt, xyz)
    else:
        m = R.RPMNetEarlyFusion(R.RPMNetConfig(feat_dim=32, dtype="bfloat16"))
        normals = torch.nn.functional.normalize(xyz, dim=-1)
        args = (xyz, normals, tgt, torch.nn.functional.normalize(tgt, dim=-1))
    return m.to(device), tuple(a.to(device) for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dcp", "fmr", "rpmnet"])
def test_bf16_forward_on_card_against_cpu(cuda_device, name, monkeypatch):
    from a_robust_registration_loss_tpu_torch.models import rpmnet as R

    m, args = _bf16_case(name, cuda_device)
    seen, real = [], R.query_ball_point_excl
    monkeypatch.setattr(R, "query_ball_point_excl",
                        lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    with torch.no_grad():
        card = m(*args, maxiter=3) if name == "fmr" else m(*args)
    handed = iter([i.cpu() for i in seen])
    monkeypatch.setattr(R, "query_ball_point_excl", lambda *a, **k: next(handed))
    m_cpu, args_cpu = m.cpu(), tuple(a.cpu() for a in args)
    with torch.no_grad():
        cpu = m_cpu(*args_cpu, maxiter=3) if name == "fmr" else m_cpu(*args_cpu)
    if name == "dcp":
        pairs = list(zip(card[:2], cpu[:2]))
    elif name == "fmr":
        pairs = [(card["g"], cpu["g"])]
        loss = (float(card["loss_ende"]), float(cpu["loss_ende"]))
        assert abs(loss[0] - loss[1]) <= 0.05 * abs(loss[1])
    else:
        pairs = list(zip(card[0], cpu[0]))
    for a, b in pairs:
        assert a.dtype == b.dtype == torch.float32
        assert float((a.cpu() - b).abs().max()) <= 0.05


@pytest.mark.cuda
def test_wrappers_refuse_a_bf16_input(cuda_device):
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    f32 = dict(device=cuda_device, dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        IK.stage1((torch.zeros((4, 9), **bf),), torch.zeros((3, 6), **bf),
                  (torch.zeros(4, **bf),), 2)
    with pytest.raises(ValueError, match="float32"):
        IK.stage1((torch.zeros((4, 9), **f32),), torch.zeros((3, 6), **f32),
                  (torch.zeros(4, **bf),), 2)
    with pytest.raises(ValueError, match="float32"):
        RS.sample_and_hit(torch.zeros((4, 8), **bf), 1.0, torch.zeros(3, **f32),
                          torch.zeros((24, 16), **f32))
    with pytest.raises(ValueError, match="float32"):
        RS.sample_and_hit(torch.zeros((4, 8), **f32), torch.tensor(1.0, **bf),
                          torch.zeros(3, **f32), torch.zeros((24, 16), **f32))
    with pytest.raises(ValueError, match="float32"):
        GK.gather_rows(torch.zeros((1, 4, 6), **bf),
                       torch.zeros((1, 3), dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="float32"):
        PB.logistic_map(torch.zeros(8, **bf), 1)


@pytest.mark.cuda
def test_sp2_step_on_one_card_over_gloo(cuda_device, tmp_path):
    import torch_parallel_ranks as TR

    p = TR.problem(B=4)
    v, dR, dt = TR.metric_rt(p, device="cuda")
    loss, new = TR.classical_step(p, device="cuda")
    L = p["lines"].shape[1]
    for out in TR.launch(TR.card_sp2, 1, 2, tmp_path, args=(p,), device="cuda"):
        assert out["swept"] == [L // 2, L // 2] and out["launches"] == 2
        assert torch.equal(out["v"], v.cpu())
        for got, want in ((out["dR"], dR), (out["dt"], dt)):
            assert float((got - want.cpu()).norm() / want.norm()) <= 1e-5
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(out["new"].numpy(), new.cpu().numpy(), rtol=1e-6, atol=1e-7)


def _classical_runs(device, n_epochs, modes):
    """``_loop`` from one seed in each mode: (carry, history, launches) each."""
    v1, v2 = _cloud(1200, 9), _cloud(1200, 10)
    cfg = TC.ClassicalConfig(n_epochs=n_epochs, n_lines=2000, num_sample=512, log_every=4)
    data = TC.prepare_pair(v1, v2, cfg, device=device)
    out = {}
    for mode in modes:
        g = torch.Generator(device=device).manual_seed(cfg.seed)
        params = TC.init_twist(g)
        IK.launches.clear()
        RS.launches.clear()
        carry, hist = TC._loop(cfg, TC.make_step(cfg, data), params, data["src"], g, None,
                               mode=mode)
        torch.cuda.synchronize()
        out[mode] = carry, hist, (dict(IK.launches), dict(RS.launches))
    return out


@pytest.mark.cuda
def test_classical_graph_replay_equals_the_eager_step(cuda_device):
    """Ten epochs through the classical step's CUDA graph equal the eager
    loop's bit for bit: every epoch's metrics, the twist, both moments, the
    count and the moved source."""
    runs = _classical_runs(cuda_device, 10, ("eager", "graph"))
    (ce, he, _), (cg, hg, _) = runs["eager"], runs["graph"]
    for k in he:
        assert np.array_equal(he[k], hg[k]), k
    for a, b in zip(torch.utils._pytree.tree_leaves(ce), torch.utils._pytree.tree_leaves(cg)):
        assert torch.equal(a, b)
    assert int(cg[1].count) == 10


@pytest.mark.cuda
def test_graph_launch_counters_count_per_replay(cuda_device):
    """A graph's run counts one stage-1 and one resampler launch an epoch,
    as the eager loop does: the capture's count is taken back, each replay
    adds it."""
    from a_robust_registration_loss_tpu_torch.train import graphs

    runs = _classical_runs(cuda_device, 7, ("eager", "graph"))
    pts = IK.instantiation(2, False, False, True)
    want = ({pts: 7}, {"single": 7})
    assert runs["eager"][2] == want and runs["graph"][2] == want
    x = torch.zeros(4, device=cuda_device)
    IK.launches.clear()
    RS.launches.clear()
    g = graphs.Graph(lambda: LN.resample_lines(
        torch.rand((4, LN.ROUNDS * 16), device=cuda_device), x[0] + 1.0, x[:3],
        16, torch.randn(8, 3, device=cuda_device), torch.randn(8, 3, device=cuda_device)))
    assert RS.launches.get("single", 0) == 0 and g.counts == {("resample", "single"): 1}
    for _ in range(3):
        g.replay()
    assert RS.launches["single"] == 3


@pytest.mark.cuda
def test_dcp_graphed_train_step_equals_the_eager_one(cuda_device):
    """Three DCP train steps through the scanned epoch's graphs (the
    network to the SVD head's correlations, the SVDs eagerly, the loss, the
    update) equal three eager steps from the same weights and uniforms: the
    metrics, the parameters and the Adam state, bit for bit."""
    from a_robust_registration_loss_tpu_torch.data import dataset as DS
    from a_robust_registration_loss_tpu_torch.train import harness as H

    cfg = TD.DCPTrainConfig(loss=LS.LossConfig(n_lines=2000), model=D.DCPConfig(
        emb_nn="pointnet", emb_dims=64, ff_dims=128, n_heads=2))
    batches = [_dcp_batch(2, 256, 128, seed) for seed in (0, 1, 2)]

    class Cache:  # the DeviceCache interface the scan reads: a device and gather
        device = cuda_device
        data = {k: torch.cat([b[k] for b in batches]).to(cuda_device) for k in batches[0]}
        gather = DS.DeviceCache.gather

    cache = Cache()
    rows = torch.arange(6, device=cuda_device).reshape(3, 2)
    out = {}
    for graphed in (False, True):
        model = TD.init_model(cfg, 0, cuda_device)
        opt = H.adam_init(model.parameters())
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        scan = H._Scan(TD.train_split(cfg), model, cache, 2)
        metrics = []
        for row in rows:
            if graphed:
                opt, m = scan(row, gen, opt)
            else:
                opt, m = TD.train_step(model, opt, cache.gather(row), cfg, generator=gen)
            metrics.append({k: v.clone() for k, v in m.items()})
        out[graphed] = metrics, [p.detach().clone() for p in model.parameters()], opt, scan
    (me, pe, oe, _), (mg, pg, og, scan) = out[False], out[True]
    assert type(scan.step).__name__ == "_GraphStep" and scan.step.pieces[0].replays == 2
    for a, b in zip(me, mg):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), a
    assert all(torch.equal(a, b) for a, b in zip(pe, pg))
    assert all(torch.equal(a, b) for a, b in zip(oe, og)) and int(og.count) == 3
