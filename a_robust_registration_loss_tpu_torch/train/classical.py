"""Classical single-pair SE(3) registration with the robust metric.

Port of ``a_robust_registration_loss_tpu/train/classical.py``: optimise a
6-DoF twist with Adam so that the transformed source cloud's intersection
metric against the target is minimised. Per epoch: resample lines against
the bounding boxes of the previously transformed source and the target,
evaluate the rigid metric, differentiate through ``se3.exp3``, and take an
Adam step that is frozen (params, both moments and the count) on an epoch
with no usable line.

Semantics kept from the JAX package: the twist init (random unit axis *
0.001, 0.001 * N(0, 1) translation, or a perturbed log of a given (R, t));
``points @ R + t``; the lr 2e-2 halved every 1000 epochs *including epoch
0*; chamfer distance as the independent check metric.

Batched mode (``prepare_pairs``, ``make_batch_step``, ``run_batch``): B
pairs registered at once, every per-pair tensor with a leading batch axis,
one resampler launch and one stage-1 launch per epoch for all B. As in
optax, the Adam count (and with it the bias correction and the lr
schedule) is one scalar shared by the (B, 6) twists: a pair with no usable
line keeps its twist and moments, and the count advances while any pair is
valid.

PyTorch idiom: the step is a plain function, ``run`` a Python loop over
steps with no host sync inside a step; all randomness comes from one
``torch.Generator``. The step carry is ``(params, AdamState, src_prev)``,
as the JAX carry is ``(params, opt_state, src_prev)``. Where the JAX
package scans a block of steps in one program, on the card the loop
replays a CUDA graph of the step once an epoch (``_loop``,
``train/graphs.py``); on the CPU it calls the step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.ops import adam
from a_robust_registration_loss_tpu_torch.ops import geometry as G
from a_robust_registration_loss_tpu_torch.ops import lines as LN
from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.ops.adam import AdamState
from a_robust_registration_loss_tpu_torch.se3 import se3
from a_robust_registration_loss_tpu_torch.train import graphs
from a_robust_registration_loss_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class ClassicalConfig:
    n_epochs: int = 1000
    n_lines: int = 20000
    num_sample: int = 5000        # FPS seeds for the neighbourhoods
    lr: float = 2e-2
    lr_halve_every: int = 1000
    kmin: int = 1
    kmax: int = 4
    log_every: int = 10           # epochs per block between host fetches
    seed: int = 123
    compute_chamfer: bool = True


def init_twist(generator, rotation=None, translation=None):
    """Twist init: 0.001 * random unit axis and 0.001 * N(0, 1)
    translation, or the log of a given (R, t) plus U(0, 0.6) noise. The
    generator's device is the twist's device."""
    dev = generator.device
    if rotation is None or translation is None:
        axis = torch.randn(3, generator=generator, device=dev)
        axis = axis / torch.linalg.vector_norm(axis)
        trans = torch.randn(3, generator=generator, device=dev) * 0.001
        return torch.cat([0.001 * axis, trans])
    g = torch.eye(4, device=dev)
    g[:3, :3] = torch.as_tensor(rotation, dtype=torch.float32, device=dev).reshape(3, 3)
    g[:3, 3] = torch.as_tensor(translation, dtype=torch.float32, device=dev).reshape(3)
    perturb = torch.rand(6, generator=generator, device=dev) * 0.6
    return se3.log(g).reshape(-1) + perturb


init_adam = adam.init  # a fresh AdamState shaped like the twist(s)


def from_jax_state(params, opt_state, device=None):
    """The JAX twist and optax Adam state -> the port's (params, AdamState).

    params: the (6,) twist, or the (B, 6) twists of a batch; opt_state:
    (count, mu, nu) as numpy arrays, the fields of optax's ScaleByAdamState
    (a scalar count, moments shaped like params). Shapes are kept."""
    dev = _device.resolve(device)
    count, mu, nu = opt_state

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return f32(params), AdamState(
        torch.tensor(np.asarray(count, np.int32), device=dev).reshape(()),
        f32(mu), f32(nu))


def apply_twist(params, points, point_neis):
    """points @ R + t on the cloud and its flattened neighbourhoods."""
    R, t = se3.exp3(params.reshape(6))
    pts = points @ R + t
    neis = (point_neis.reshape(-1, 3) @ R + t).reshape(point_neis.shape)
    return pts, neis


def prepare_pair(src_vertices, tar_vertices, cfg: ClassicalConfig,
                 device=None):
    """FPS + 3-NN neighbourhoods of both clouds, mean centring, target bbox
    radius, on the device. Returns a dict of tensors."""
    dev = _device.resolve(device)
    src = torch.as_tensor(np.asarray(src_vertices, np.float32), device=dev)
    tar = torch.as_tensor(np.asarray(tar_vertices, np.float32), device=dev)
    neis_src = G.sample_neighs(src, cfg.num_sample, 3)
    neis_tar = G.sample_neighs(tar, cfg.num_sample, 3)
    c1 = src.mean(0, keepdim=True)
    c2 = tar.mean(0, keepdim=True)
    src, tar = src - c1, tar - c2
    neis_src = neis_src - c1
    neis_tar = neis_tar - c2
    bbox = G.bounding_box_corners(tar[None])[0]
    return dict(
        src=src, tar=tar,
        neis_src=neis_src.reshape(-1, 9),
        neis_tar=neis_tar.reshape(-1, 9),
        radius=torch.linalg.vector_norm(bbox[0] - bbox[-1]),
        center=tar.mean(0),
        center_src=c1, center_tar=c2,
    )


def lr_schedule(cfg: ClassicalConfig):
    """lr halved at every multiple of lr_halve_every INCLUDING step 0."""
    def fn(step):
        return cfg.lr * 0.5 ** (1 + step // cfg.lr_halve_every)
    return fn


def adam_update(cfg: ClassicalConfig, params, opt: AdamState, grads, valid):
    """One optax.adam step at the schedule's lr, frozen where ``valid`` is
    False: params, both moments and the count stay as they were. For a
    batch (params (B, 6), ``valid`` (B,)) a pair's row freezes where its
    valid is False, and the shared count only when no pair is valid."""
    keep = valid[..., None] if valid.dim() else valid
    # lr at the pre-increment count
    return adam.step(lr_schedule(cfg)(opt.count), grads, opt, params, keep)


def update(cfg: ClassicalConfig, data, carry, lines):
    """One epoch on given lines: metric, gradient, masked Adam step.
    carry = (params, AdamState, src_prev) -> (carry, metrics)."""
    params, opt, _ = carry
    p = params.detach().requires_grad_(True)
    R, t = se3.exp3(p)
    loss, valid = M.intersection_loss_rigid(
        R, t, data["neis_src"], data["neis_tar"], lines, cfg.kmin, cfg.kmax)
    (grads,) = torch.autograd.grad(loss, p, allow_unused=True)
    with torch.no_grad():
        grads = torch.zeros_like(p) if grads is None else grads
        src_t = data["src"] @ R + t
        params, opt = adam_update(cfg, params, opt,
                                  torch.where(valid, grads, 0.0), valid)
        if cfg.compute_chamfer:
            chamfer = G.chamfer_distance(src_t[None], data["tar"][None])
        else:
            chamfer = torch.zeros((), device=src_t.device)
    return (params, opt, src_t), dict(loss=loss.detach(), chamfer=chamfer,
                                      valid=valid)


def make_step(cfg: ClassicalConfig, data):
    """The single-epoch step: ``step(carry, u4) -> (carry, metrics)``, with
    u4 the (4, ROUNDS * n_lines) uniforms of the epoch's resampling against
    the bbox of the previously transformed source (carry[2])."""
    def step(carry, u4):
        lines = LN.resample_lines(u4, data["radius"], data["center"],
                                  cfg.n_lines, carry[2], data["tar"])
        return update(cfg, data, carry, lines)
    return step


def run(src_vertices, tar_vertices, cfg: ClassicalConfig = ClassicalConfig(),
        callback=None, init_params=None, device=None):
    """Full optimisation. ``callback(epoch, params, metrics, src_transformed)``
    (host values) fires once per block of cfg.log_every epochs, one block
    late so its fetch overlaps the next block's work. Returns (params, history
    dict of per-epoch metric arrays)."""
    with span("arrl.classical.run"):
        dev = _device.resolve(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        with span("arrl.classical.prepare"):
            data = prepare_pair(src_vertices, tar_vertices, cfg, dev)
        if init_params is None:
            params = init_twist(gen)
        else:
            params = torch.as_tensor(np.asarray(init_params, np.float32),
                                     device=dev).reshape(6)
        carry, hist = _loop(cfg, make_step(cfg, data), params, data["src"], gen, callback)
        return carry[0], hist


def _loop(cfg: ClassicalConfig, step, params, src, gen, callback, mode=None):
    """The epochs of ``run`` and ``run_batch``: blocks of cfg.log_every
    steps, each step's uniforms drawn from ``gen`` (shaped (4, C), or
    (B, 4, C) for a batch of twists (B, 6)), each block's metrics fetched
    one block late.

    ``mode``: "eager", the reference, calls ``step`` once an epoch; "graph"
    (the card only) replays a CUDA graph of the step (``train/graphs.py``,
    the JAX package's scanned block); "static" runs the graph's loop with
    the step called eagerly in its place, the graph's stand-in on the CPU.
    By default "graph" on the card and "eager" on the CPU. Returns (the
    final carry, the history of per-epoch metric arrays)."""
    if mode is None:
        mode = "graph" if params.is_cuda else "eager"
    if mode not in ("eager", "graph", "static"):
        raise ValueError(f"_loop: unknown mode {mode!r}")
    carry = (params, init_adam(params), src)
    u4_shape = params.shape[:-1] + (4, LN.ROUNDS * cfg.n_lines)
    epochs = _eager_block if mode == "eager" else _static_block
    # the static carry changes in place: a block's end is kept as a copy
    keep = (lambda t: t) if mode == "eager" else torch.clone
    state = dict(mode=mode, graph=None)
    history = []
    pending = None
    done = 0
    try:
        while done < cfg.n_epochs:
            # the final block runs only the remaining epochs
            n = min(cfg.log_every, cfg.n_epochs - done)
            with span("arrl.classical.block"):
                carry, block = epochs(step, carry, u4_shape, gen, n, state)
            done += n
            if pending is not None:
                _flush(pending, history, callback)
            pending = (done, keep(carry[0]), block, keep(carry[2]))
        if pending is not None:
            _flush(pending, history, callback)
    finally:
        with span("arrl.classical.release"):
            state.clear()  # the graph and its memory pool go with the run
    hist = {k: np.concatenate([h[k] for h in history]) for k in history[0]}
    return carry, hist


def _eager_block(step, carry, u4_shape, gen, n, state):
    """n epochs, a step call each; the block's metrics stacked."""
    block = []
    for _ in range(n):
        u4 = torch.rand(u4_shape, generator=gen, device=carry[0].device)
        carry, metrics = step(carry, u4)
        block.append(metrics)
    return carry, {k: torch.stack([m[k] for m in block]) for k in block[0]}


def _static_block(step, carry, u4_shape, gen, n, state):
    """n epochs through static buffers: each epoch's uniforms drawn into
    one buffer (the same draw as ``torch.rand(u4_shape)``), then the graph
    replayed ("graph") or the step called on the static carry ("static"),
    its metrics copied into the block's preallocated rows before the next
    epoch overwrites them. The first epoch of a run is an eager step on the
    run's own state: it builds what the capture must find built (the
    kernel library, cuBLAS's handles), and its carry becomes the static
    carry that the graph updates in place."""
    dev = carry[0].device
    if "u4" not in state:
        state["u4"] = torch.empty(u4_shape, device=dev)
    u4 = state["u4"]
    rows = None
    for i in range(n):
        torch.rand(u4_shape, generator=gen, device=dev, out=u4)
        if state["graph"] is None:
            with span("arrl.classical.capture"):
                carry, metrics = step(carry, u4)
                if state["mode"] == "graph":
                    state["graph"] = graphs.step_graph(step, carry, (u4,))
                else:
                    state["graph"] = _EagerStep(step, carry, (u4,))
        else:
            metrics = state["graph"].replay()
        if rows is None:
            rows = {k: torch.empty((n, *v.shape), dtype=v.dtype, device=dev)
                    for k, v in metrics.items()}
        for k, v in metrics.items():
            rows[k][i].copy_(v)
    return carry, rows


class _EagerStep:
    """``graphs.step_graph``'s stand-in on the CPU: each replay calls the
    step on the static carry and copies the new carry into it."""

    def __init__(self, step, carry, inputs):
        self.step, self.carry, self.inputs = step, carry, inputs

    def replay(self):
        new, out = self.step(self.carry, *self.inputs)
        graphs.copy_carry(self.carry, new)
        return out


def _flush(pending, history, callback):
    """Fetch a finished block's metrics to the host (one sync per block)
    and fire the callback with host values."""
    done, params, metrics, src_t = pending
    with span("arrl.classical.fetch"):
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        history.append(metrics)
        if callback is not None:
            callback(done, params.cpu().numpy(),
                     {k: v[-1] for k, v in metrics.items()}, src_t.cpu().numpy())


def final_transform(params):
    """(R, t) of the optimised twist, plus the 3x4 [R | t] matrix, in numpy
    float64 (the same math as se3.exp3: Rodrigues + V, sinc Taylor
    branches)."""
    if isinstance(params, torch.Tensor):
        params = params.detach().cpu().numpy()
    x = np.asarray(params, np.float64).reshape(6)
    w, v = x[:3], x[3:]
    t = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]],
                  [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]])
    S = W @ W
    if t < 0.01:  # the sinc Taylor cutoff (se3/sinc.py)
        t2 = t * t
        s1 = 1 - t2 / 6 * (1 - t2 / 20 * (1 - t2 / 42))
        s2 = 0.5 * (1 - t2 / 12 * (1 - t2 / 30 * (1 - t2 / 56)))
        s3 = (1 / 6) * (1 - t2 / 20 * (1 - t2 / 42 * (1 - t2 / 72)))
    else:
        s1 = np.sin(t) / t
        s2 = (1 - np.cos(t)) / (t * t)
        s3 = (t - np.sin(t)) / (t * t * t)
    I = np.eye(3)
    R = I + s1 * W + s2 * S
    V = I + s2 * W + s3 * S
    p = V @ v
    out = np.ones((3, 4), np.float64)
    out[:3, :3] = R
    out[:3, 3] = p
    return R.astype(np.float32), p.astype(np.float32), out


# ---------------------------------------------------------------------------
# Batched multi-pair registration: every per-pair tensor gains a leading
# batch axis; Adam is elementwise, so per-pair moments ride along as (B, 6)
# rows, and each pair's gradient depends only on its own twist row.
# ---------------------------------------------------------------------------

def prepare_pairs(src_batch, tar_batch, cfg: ClassicalConfig, device=None):
    """Batched prepare_pair: (B, N, 3) x (B, M, 3) -> dict of (B, ...)
    tensors, with the seed count clamped to min(cfg.num_sample, N, M)."""
    dev = _device.resolve(device)
    src = torch.as_tensor(np.asarray(src_batch, np.float32), device=dev)
    tar = torch.as_tensor(np.asarray(tar_batch, np.float32), device=dev)
    n = min(cfg.num_sample, src.shape[1], tar.shape[1])
    neis_src = G.sample_neighs(src, n, 3)
    neis_tar = G.sample_neighs(tar, n, 3)
    c1 = src.mean(1, keepdim=True)
    c2 = tar.mean(1, keepdim=True)
    src, tar = src - c1, tar - c2
    neis_src = neis_src - c1
    neis_tar = neis_tar - c2
    bbox = G.bounding_box_corners(tar)
    B = src.shape[0]
    return dict(
        src=src, tar=tar,
        neis_src=neis_src.reshape(B, n, 9),
        neis_tar=neis_tar.reshape(B, n, 9),
        radius=torch.linalg.vector_norm(bbox[:, 0] - bbox[:, -1], dim=-1),
        center=tar.mean(1),
        center_src=c1, center_tar=c2,
    )


def batch_update(cfg: ClassicalConfig, data, carry, lines):
    """One epoch of B pairs on given lines (B, L, 6): the per-pair metric
    (one stage-1 launch), the gradient of the sum of the valid pairs'
    losses, the masked Adam step, then the sources moved by the NEW twists
    (the next epoch's resampling boxes) and their chamfer distances.
    carry = (params (B, 6), AdamState, src_prev (B, N, 3)) -> (carry,
    metrics of shape (B,))."""
    params, opt, _ = carry
    p = params.detach().requires_grad_(True)
    R, t = se3.exp3(p)
    loss, valid = M.intersection_loss_rigid(
        R, t, data["neis_src"], data["neis_tar"], lines, cfg.kmin, cfg.kmax)
    losses = torch.where(valid, loss, 0.0)
    (grads,) = torch.autograd.grad(losses.sum(), p, allow_unused=True)
    with torch.no_grad():
        grads = torch.zeros_like(p) if grads is None else grads
        params, opt = adam_update(cfg, params, opt,
                                  torch.where(valid[:, None], grads, 0.0), valid)
        R, t = se3.exp3(params)
        src_t = data["src"] @ R + t[:, None, :]
        if cfg.compute_chamfer:
            chamfer = G.chamfer_distance(src_t, data["tar"], per_sample=True)
        else:
            chamfer = torch.zeros(params.shape[0], device=src_t.device)
    return (params, opt, src_t), dict(loss=losses.detach(), chamfer=chamfer,
                                      valid=valid)


def make_batch_step(cfg: ClassicalConfig, data):
    """The batched epoch: ``step(carry, u4) -> (carry, metrics)`` with u4
    the (B, 4, ROUNDS * n_lines) uniforms of each pair's resampling against
    the bbox of its previously transformed source (carry[2]); one batched
    resampler launch."""
    def step(carry, u4):
        lines = LN.resample_lines(u4, data["radius"], data["center"],
                                  cfg.n_lines, carry[2], data["tar"])
        return batch_update(cfg, data, carry, lines)
    return step


def run_batch(src_batch, tar_batch, cfg: ClassicalConfig = ClassicalConfig(),
              callback=None, init_params=None, device=None):
    """Optimise B registrations at once. src_batch/tar_batch: (B, N, 3) /
    (B, M, 3). The twists start from B draws of ``init_twist`` from the
    run's one generator, unless ``init_params`` (B, 6) is given; the
    callback as in ``run``, with per-pair (B,) metrics. Returns (params
    (B, 6), history of (n_epochs, B) metric arrays)."""
    with span("arrl.classical.run"):
        dev = _device.resolve(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        with span("arrl.classical.prepare"):
            data = prepare_pairs(src_batch, tar_batch, cfg, dev)
        B = data["src"].shape[0]
        if init_params is None:
            params = torch.stack([init_twist(gen) for _ in range(B)])
        else:
            params = torch.as_tensor(np.asarray(init_params, np.float32),
                                     device=dev).reshape(B, 6)
        carry, hist = _loop(cfg, make_batch_step(cfg, data), params, data["src"], gen,
                            callback)
        return carry[0], hist
