#!/usr/bin/env python
"""Classical registration demo on the GPU: one pair, or a batch of pairs.

    python -m a_robust_registration_loss_tpu_torch.demo --data_path DIR \
        --label1 0 --Save_path ./results/demo [--device cpu]
    python -m a_robust_registration_loss_tpu_torch.demo --data_path DIR \
        --labels 0,1,2,3 --Save_path ./results/batch

Port of ``a_robust_registration_loss_tpu/demo.py``, with its flags, printed
lines and files. Loads ``{label}_src_sample.obj`` / ``{label}_tar_sample.obj``,
optimises a 6-DoF twist with Adam against the intersected-line metric and
writes the transformed source (``{epoch}.obj``) and its 3x4 transform
(``{epoch}_transform.txt``) every --log_every epochs, then ``target.obj``,
the coloured ply triple and ``registration.png``, printing the chamfer
distance as the independent check. With --labels every listed pair is
registered at once (``train/classical.py:run_batch``), writing
``{label}_transform.txt`` per pair.
"""

import argparse
import os
import time

import numpy as np


def main_batch(args):
    """Batched mode: register every pair in --labels at once, one resampler
    launch and one stage-1 launch per epoch for all of them."""
    from a_robust_registration_loss_tpu_torch.data import objio
    from a_robust_registration_loss_tpu_torch.train import classical

    labels = args.labels.split(",")
    srcs, tars = [], []
    for lb in labels:
        v1, _ = objio.read_obj(os.path.join(args.data_path, f"{lb}_src_sample.obj"))
        v2, _ = objio.read_obj(os.path.join(args.data_path, f"{lb}_tar_sample.obj"))
        srcs.append(v1)
        tars.append(v2)
    cfg = classical.ClassicalConfig(
        n_epochs=args.n_epochs, n_lines=args.n_lines,
        num_sample=args.num_sample, seed=args.seed, log_every=args.log_every)
    os.makedirs(args.Save_path, exist_ok=True)
    t0 = time.perf_counter()
    state = {"t1": None, "e1": 0}

    def callback(epoch, params, metrics, src_t):
        if state["t1"] is None:
            state["t1"] = time.perf_counter()  # after the first block
            state["e1"] = epoch
        print(f"epoch {epoch:5d}  chamfer " +
              " ".join(f"{c:.4f}" for c in metrics["chamfer"]))

    params, hist = classical.run_batch(np.stack(srcs), np.stack(tars), cfg,
                                       callback=callback, device=args.device)
    dt = time.perf_counter() - t0
    steady = time.perf_counter() - (state["t1"] or t0)
    steady_epochs = args.n_epochs - state["e1"]
    params = params.cpu().numpy()
    for j, lb in enumerate(labels):
        _, _, transform = classical.final_transform(params[j])
        np.savetxt(os.path.join(args.Save_path, f"{lb}_transform.txt"),
                   transform)
    print(f"{len(labels)} pairs x {args.n_epochs} epochs in {dt:.1f}s; "
          f"steady-state {len(labels) * steady_epochs / steady:.1f} pair-iters/sec")
    print("final chamfers:", " ".join(f"{c:.4f}" for c in hist["chamfer"][-1]))
    return hist


def main(args):
    from a_robust_registration_loss_tpu_torch.data import objio
    from a_robust_registration_loss_tpu_torch.train import classical
    from a_robust_registration_loss_tpu_torch.utils import viz

    v1, _ = objio.read_obj(os.path.join(args.data_path, args.label1 + "_src_sample.obj"))
    v2, _ = objio.read_obj(os.path.join(args.data_path, args.label1 + "_tar_sample.obj"))
    cfg = classical.ClassicalConfig(
        n_epochs=args.n_epochs, n_lines=args.n_lines,
        num_sample=args.num_sample, seed=args.seed, log_every=args.log_every)
    os.makedirs(args.Save_path, exist_ok=True)
    t0 = time.perf_counter()
    state = {"epochs_done": 0, "t_start": None}

    def callback(epoch, params, metrics, src_t):
        if state["t_start"] is None:
            state["t_start"] = time.perf_counter()  # after the first block
            state["epochs_at_start"] = epoch
        print(
            f"epoch {epoch:5d}  chamfer {float(metrics['chamfer']):.6f}  "
            f"intersection {float(metrics['loss']):.6f}"
        )
        objio.write_obj(os.path.join(args.Save_path, f"{epoch}.obj"), src_t)
        _, _, transform = classical.final_transform(params)
        np.savetxt(os.path.join(args.Save_path, f"{epoch}_transform.txt"), transform)
        state["epochs_done"] = epoch

    params, hist = classical.run(v1, v2, cfg, callback=callback, device=args.device)
    objio.write_obj(os.path.join(args.Save_path, "target.obj"),
                    np.asarray(v2) - v2.mean(0, keepdims=True))
    _, _, t34 = classical.final_transform(params)
    g = np.eye(4)
    # final_transform is row-convention (p @ R + t); draw_... applies column
    g[:3, :3] = t34[:, :3].T
    g[:3, 3] = t34[:, 3]
    try:
        import matplotlib  # noqa: F401
        png = True
    except ImportError as e:
        png = False
        print(f"registration.png skipped: matplotlib does not import ({e}); "
              "the ply triple is written")
    viz.draw_registration_result(
        np.asarray(v1) - v1.mean(0, keepdims=True),
        np.asarray(v2) - v2.mean(0, keepdims=True), g, args.Save_path, png=png)
    elapsed = time.perf_counter() - (state["t_start"] or t0)
    steady_epochs = state["epochs_done"] - state.get("epochs_at_start", 0)
    if steady_epochs > 0:
        print(f"steady-state: {steady_epochs / elapsed:.2f} iters/sec")
    print(f"final chamfer {hist['chamfer'][-1]:.6f}  "
          f"intersection {hist['loss'][-1]:.6f}")
    return hist


def cli(argv=None):
    """Console entry; argv defaults to sys.argv[1:]. Returns the run's
    history (per-epoch metric arrays, (n_epochs, B) in batched mode)."""
    parser = argparse.ArgumentParser(
        description="Classical robust-metric registration of OBJ pairs.",
        epilog="The JAX demo's --backend and --line_chunk have no counterpart "
               "here: the tensor's device picks each kernel or its plain "
               "PyTorch version, and stage 1 never chunks its lines.")
    parser.add_argument("--data_path", type=str, required=True,
                        help="directory of {label}_src_sample.obj / "
                             "{label}_tar_sample.obj pairs")
    parser.add_argument("--label1", type=str, default="0")
    parser.add_argument("--Save_path", type=str, default="./results/demo")
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--n_epochs", type=int, default=1000)
    parser.add_argument("--n_lines", type=int, default=20000)
    parser.add_argument("--num_sample", type=int, default=5000)
    parser.add_argument("--log_every", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the kernels) or cpu (their "
                             "plain PyTorch versions); raises when cuda is "
                             "asked for and there is no GPU")
    parser.add_argument("--labels", type=str, default=None,
                        help="comma-separated labels for BATCHED multi-pair "
                             "registration")
    args = parser.parse_args(argv)
    return main_batch(args) if args.labels else main(args)


if __name__ == "__main__":
    cli()
