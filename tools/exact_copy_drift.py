#!/usr/bin/env python3
"""Trace the classical registration, epoch by epoch, on one of
``chip_smoke.py``'s synthetic pairs, and compare traces.

    python3 tools/exact_copy_drift.py run --out DIR/kernel.npz [--device cuda]
    python3 tools/exact_copy_drift.py run --out DIR/plain.npz --plain
    python3 tools/exact_copy_drift.py run --out DIR/cpu.npz --device cpu
    python3 tools/exact_copy_drift.py compare DIR/kernel.npz DIR/plain.npz

``run`` is the demo's single-pair loop (``train/classical.py:run`` at the
demo's default widths and seed) with every epoch's state kept: the loss, the
stage-2 distance median, the chamfer distance, the gradient, the twist, the
Adam moments, and the rotation and translation error of the twist against
the pair's planted motion. The uniforms are drawn as ``run`` draws them, from
a generator seeded with the config's seed on the uniforms' device
(``--uniforms``, default the run's device); the data are prepared on
``--prepare_on`` (default the run's device) and moved. So a ``--device cpu``
run with ``--uniforms cuda --prepare_on cuda`` sees the same uniforms and
neighbourhoods as the card's run, on the plain PyTorch versions of the
kernels. ``--plain`` keeps the tensors on the card and routes stage 1 and
the resampler to their plain versions there, the rest of the step
unchanged: its trace equals the kernel run's bit for bit where the kernels
equal their plain versions.

``compare`` prints (and returns) the first epoch where two traces differ
and the largest differences. ``jax`` (where the JAX package and JAX are installed, on the
CPU) runs the JAX package's stage 2 and the port's on the slot points a
``run`` kept in its epoch of the largest gradient and the one before:

    python3 tools/exact_copy_drift.py jax DIR/kernel.npz

``jax-run`` runs the JAX package's whole classical ``run`` (``--port``: the
port's) on the CPU on one pair and prints its chamfer trace:

    python3 tools/exact_copy_drift.py jax-run --n 2048 --n_lines 10000 --epochs 300
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIELDS = ("loss", "median", "chamfer", "valid", "grad", "twist", "mu", "nu",
          "rot_err", "trans_err")


@contextlib.contextmanager
def _patched(patches):
    """Set each (module, name, value) for the duration, then restore."""
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    try:
        for m, k, v in patches:
            setattr(m, k, v)
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def trace(args):
    """The demo's loop with every epoch's state kept (module docstring);
    saves the trace to ``args.out`` and returns it."""
    import torch

    import chip_smoke as CS
    from a_robust_registration_loss_tpu_torch.ops import lines as LN
    from a_robust_registration_loss_tpu_torch.ops import metric as M
    from a_robust_registration_loss_tpu_torch.ops.cuda import intersect as IK
    from a_robust_registration_loss_tpu_torch.ops.cuda import resample as RS
    from a_robust_registration_loss_tpu_torch.train import classical as C

    torch.set_num_threads(args.threads)
    dev = args.device
    udev = args.uniforms or dev
    pdev = args.prepare_on or dev
    medians, slots, grads = [], [], []

    def stage2_median(pts1, pts2, c1, c2, kmin, kmax):
        # the median stage 2 divides by, recomputed from its own inputs
        with torch.no_grad():
            lvalid = (c1 >= kmin) & (c1 <= kmax) & (c2 >= kmin) & (c2 <= kmax)
            ok1 = M._slot_mask(c1, kmax) & lvalid[..., None]
            ok2 = M._slot_mask(c2, kmax) & lvalid[..., None]
            diff = [pts1[..., :, :, None, c] - pts2[..., :, None, :, c] for c in range(3)]
            D = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
            medians.append(M._masked_lower_median(D, ok1[..., :, :, None] & ok2[..., :, None, :],
                                                  D.dim() - 3))
            slots.append((pts1.detach(), pts2.detach(), c1, c2))
        return stage2(pts1, pts2, c1, c2, kmin, kmax)

    def adam_update(cfg_, params_, opt, g, valid):
        grads.append(g.detach().clone())
        return update(cfg_, params_, opt, g, valid)

    stage2, update = M.stage2, C.adam_update
    patches = [(M, "stage2", stage2_median), (C, "adam_update", adam_update)]
    if args.plain:
        patches += [(IK, "stage1", lambda neis, lines, deltas, kmax=IK.KMAX, **kw:
                     IK.stage1_reference(neis, lines, deltas, kmax, **kw)),
                    (RS, "sample_and_hit", RS.sample_and_hit_reference)]

    src, tar = CS.synthetic_pairs(args.pair + 1, args.n, exact=args.exact)
    src, tar = src[args.pair], tar[args.pair]
    cfg = C.ClassicalConfig(n_epochs=args.epochs, n_lines=args.n_lines,
                            num_sample=args.num_sample, seed=args.seed)
    rec = {k: [] for k in FIELDS}
    with _patched(patches):
        data = {k: v.to(dev) for k, v in C.prepare_pair(src, tar, cfg, pdev).items()}
        gen = torch.Generator(device=udev)
        gen.manual_seed(cfg.seed)
        params = C.init_twist(gen).to(dev)
        carry = (params, C.init_adam(params), data["src"])
        step = C.make_step(cfg, data)
        t0 = time.perf_counter()
        for e in range(args.epochs):
            u4 = torch.rand((4, LN.ROUNDS * cfg.n_lines), generator=gen, device=udev).to(dev)
            carry, m = step(carry, u4)
            p, opt = carry[0], carry[1]
            for k, v in (("loss", m["loss"]), ("median", medians[-1]),
                         ("chamfer", m["chamfer"]), ("valid", m["valid"]), ("grad", grads[-1]),
                         ("twist", p), ("mu", opt.mu), ("nu", opt.nu)):
                rec[k].append(v.detach().clone())
        if dev == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    out = {k: torch.stack(v).cpu().numpy() for k, v in rec.items() if v}
    errs = [CS.motion_error(C.final_transform(tw)[2], args.pair) for tw in out["twist"]]
    out["rot_err"] = np.array([e[0] for e in errs])
    out["trans_err"] = np.array([e[1] for e in errs])
    # stage 2's inputs in the epoch of the largest gradient and the one before
    spike = int(np.abs(out["grad"]).max(-1).argmax())
    for tag, e in (("spike", spike), ("before", max(spike - 1, 0))):
        for k, v in zip(("pts1", "pts2", "c1", "c2"), slots[e]):
            out[f"{tag}_{k}"] = v.cpu().numpy()
    out["spike_epoch"] = spike
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **out, seconds=dt)
    summarise(args.out, out, dt)
    return out


def summarise(name, t, dt=None):
    ch, rot = t["chamfer"], t["rot_err"]
    best = int(np.argmin(ch))
    head = f"{name}: {len(ch)} epochs" + (f" in {dt:.1f} s" if dt is not None else "")
    print(f"{head}; chamfer first {ch[0]:.3g}, best {ch[best]:.3g} at epoch {best}, "
          f"last {ch[-1]:.3g}; rotation error at best {rot[best]:.3g} rad, last {rot[-1]:.3g}; "
          f"translation error last {t['trans_err'][-1]:.3g}; median min {t['median'].min():.3g} "
          f"max {t['median'].max():.3g}; |grad| max {np.abs(t['grad']).max():.3g} at epoch "
          f"{int(np.abs(t['grad']).max(-1).argmax())}; every epoch valid: "
          f"{bool(t['valid'].all())}", flush=True)
    every = max(1, len(ch) // 40)
    print(" epoch      loss      median     chamfer   rot_err   |grad|     |step|")
    steps = np.abs(np.diff(t["twist"], axis=0, prepend=t["twist"][:1])).max(-1)
    for e in range(len(ch)):
        if e % every == 0 or e == len(ch) - 1:
            print(f" {e:5d} {t['loss'][e]:.6f} {t['median'][e]:.3e} {ch[e]:.3e} {rot[e]:.3e} "
                  f"{np.abs(t['grad'][e]).max():.3e} {steps[e]:.3e}")


def compare(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    n = min(len(a["loss"]), len(b["loss"]))
    same = [all(np.array_equal(a[k][e], b[k][e]) for k in ("loss", "twist", "grad"))
            for e in range(n)]
    first = next((e for e, s in enumerate(same) if not s), None)
    print(f"{a_path} vs {b_path}: {n} epochs, " + (
        "bit-equal loss, gradient and twist in every epoch" if first is None else
        f"first difference at epoch {first}"))
    for k in ("loss", "median", "chamfer", "twist", "grad", "rot_err"):
        d = np.abs(a[k][:n] - b[k][:n]).reshape(n, -1).max(-1)
        print(f"  {k:8s} max abs diff {d.max():.3g} (epoch {int(d.argmax())}); "
              f"over the first 50 epochs {d[:50].max():.3g}")
    summarise(a_path, {k: a[k] for k in a.files})
    summarise(b_path, {k: b[k] for k in b.files})
    return first


def stage2_against_jax(path):
    """Stage 2 of the JAX package (``ops/metric.py:intersection_loss_from_slots``,
    on the CPU) and of the port (``ops/metric.py:stage2``, plain PyTorch on
    the CPU) on the slot points a ``run`` kept, in its epoch of the largest
    gradient and the one before: the median, the loss and the gradient with
    respect to cloud 1's slot points. Imports JAX (a comparison, like the
    tests), so it runs where JAX is installed."""
    import jax
    import jax.numpy as jnp
    import torch

    from a_robust_registration_loss_tpu.ops import metric as JM
    from a_robust_registration_loss_tpu_torch.ops import metric as M

    jax.config.update("jax_platforms", "cpu")
    t = np.load(path)
    e = int(t["spike_epoch"])
    results = {}
    for tag, epoch in (("before", max(e - 1, 0)), ("spike", e)):
        pts1, pts2, c1, c2 = (t[f"{tag}_{k}"] for k in ("pts1", "pts2", "c1", "c2"))
        K = pts1.shape[1]

        def jloss(p1):
            inter = [JM.Intersections(jnp.asarray(c), jnp.zeros((len(c), K), jnp.int32),
                                      jnp.zeros((len(c), K, 3))) for c in (c1, c2)]
            return JM.intersection_loss_from_slots(p1, inter[0], jnp.asarray(pts2), inter[1])[0]

        jl, jg = jax.value_and_grad(jloss)(jnp.asarray(pts1))
        jg = np.asarray(jg)
        valid = ((c1 >= 1) & (c1 <= 4) & (c2 >= 1) & (c2 <= 4))
        ok1 = (np.arange(K) < np.minimum(c1, 4)[:, None]) & valid[:, None]
        ok2 = (np.arange(K) < np.minimum(c2, 4)[:, None]) & valid[:, None]
        D = ((pts1[:, :, None, :] - pts2[:, None, :, :]) ** 2).sum(-1)
        pair_ok = ok1[:, :, None] & ok2[:, None, :]
        jm = float(JM._masked_lower_median(jnp.asarray(D), jnp.asarray(pair_ok)))
        p1 = torch.tensor(pts1, requires_grad=True)
        tl, _ = M.stage2(p1, torch.tensor(pts2), torch.tensor(c1), torch.tensor(c2), 1, 4)
        (tg,) = torch.autograd.grad(tl, p1)
        tg = tg.numpy()
        rel = np.linalg.norm(tg - jg) / np.linalg.norm(jg)
        print(f"epoch {epoch} ({tag}): run's loss {t['loss'][epoch]:.7f}, median "
              f"{t['median'][epoch]:.4g}; JAX stage 2: loss {float(jl):.7f}, median {jm:.4g}, "
              f"|grad| {np.linalg.norm(jg):.5g}; port stage 2 on the CPU: loss {tl.item():.7f}, "
              f"|grad| {np.linalg.norm(tg):.5g}, relative L2 difference of the gradients "
              f"{rel:.3g}; lines used {int(valid.sum())}", flush=True)
        results[tag] = dict(epoch=epoch, jax_loss=float(jl), jax_median=jm, port_loss=tl.item(),
                            grad_rel_l2=float(rel), jax_grad_norm=float(np.linalg.norm(jg)))
    return results


def whole_run(args):
    """The JAX package's classical ``run`` (its XLA backend, on the CPU), or
    with ``--port`` the port's on the CPU, on one of ``chip_smoke.py``'s
    pairs (exact by default) from the config's seed: the chamfer trace and
    the last twist's error against the planted motion."""
    import chip_smoke as CS
    from a_robust_registration_loss_tpu_torch.train import classical as C

    src, tar = CS.synthetic_pairs(args.pair + 1, args.n, exact=args.exact)
    src, tar = src[args.pair], tar[args.pair]
    t0 = time.perf_counter()
    if args.port:
        import torch

        torch.set_num_threads(args.threads)
        cfg = C.ClassicalConfig(n_epochs=args.epochs, n_lines=args.n_lines,
                                num_sample=args.num_sample, seed=args.seed, log_every=50)
        params, hist = C.run(src, tar, cfg, device="cpu")
    else:
        import jax

        from a_robust_registration_loss_tpu.train import classical as JC

        jax.config.update("jax_platforms", "cpu")
        cfg = JC.ClassicalConfig(n_epochs=args.epochs, n_lines=args.n_lines,
                                 num_sample=args.num_sample, seed=args.seed, log_every=50,
                                 backend="xla")
        params, hist = JC.run(src, tar, cfg)
    ch = np.asarray(hist["chamfer"])
    err = CS.motion_error(C.final_transform(np.asarray(params))[2], args.pair)
    print(f"{'port' if args.port else 'jax'} run, {args.n} points, {args.n_lines} lines, pair "
          f"{args.pair} ({'exact' if args.exact else 'noisy'}): {time.perf_counter() - t0:.1f} s; "
          f"chamfer best {ch.min():.3g} at epoch {int(ch.argmin())}, last {ch[-1]:.3g}; last "
          f"rotation error {err[0]:.3g} rad, translation {err[1]:.3g}", flush=True)
    print("chamfer every 20 epochs:", " ".join(f"{c:.2e}" for c in ch[::20]), flush=True)
    return ch


def _pair_args(p):
    """The pair and the demo's widths, shared by ``run`` and ``jax-run``."""
    p.add_argument("--noisy", dest="exact", action="store_false",
                   help="the noisy pair (default: the target an exact rigid copy)")
    for flag, default in (("--pair", 0), ("--n", 4096), ("--epochs", 200),
                          ("--n_lines", 20000), ("--num_sample", 5000), ("--seed", 123),
                          ("--threads", 8)):
        p.add_argument(flag, type=int, default=default)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--out", required=True)
    r.add_argument("--device", default="cuda")
    r.add_argument("--uniforms", default=None, help="the uniforms' device (default: --device)")
    r.add_argument("--prepare_on", default=None, help="prepare_pair's device (default: --device)")
    r.add_argument("--plain", action="store_true",
                   help="stage 1 and the resampler's plain versions on the card")
    _pair_args(r)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    j = sub.add_parser("jax", help="stage 2 of the JAX package and of the port on a run's "
                                   "kept slot points")
    j.add_argument("path")
    w = sub.add_parser("jax-run", help="the JAX package's whole classical run on the CPU "
                                       "(--port: the port's)")
    w.add_argument("--port", action="store_true")
    _pair_args(w)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return trace(args)
    if args.cmd == "compare":
        return compare(args.a, args.b)
    if args.cmd == "jax-run":
        return whole_run(args)
    return stage2_against_jax(args.path)


if __name__ == "__main__":
    main()
