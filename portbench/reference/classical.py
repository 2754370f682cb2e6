"""The plain reference of classical registration (the reference code's
``test_demo_optimized_Lie_Algebra.py``): a 6-DoF twist optimised by Adam
against the robust metric, lines resampled every epoch against the boxes
of the target and of the source as the previous epoch moved it.

``follow`` takes a pair of clouds and the run's settings and follows its
epochs from the seed: the same uniforms a run draws from a generator
seeded with ``seed`` on the device (the twist's start, then one
(4, ROUNDS * n_lines) block an epoch), the neighbourhoods, the lines, the
metric and its gradient through the exponential map, the masked Adam step
and the chamfer distance of each epoch.
"""

from __future__ import annotations

import torch

from portbench.reference import core as C


def prepare(src, tar, num_sample: int):
    """Centred clouds, their FPS + 3-NN neighbourhoods (F, 9), the sampling
    sphere of the target's box: a dict of tensors."""
    neis = [C.neighbourhoods(x[None], num_sample)[0] for x in (src, tar)]
    c1, c2 = src.mean(0, keepdim=True), tar.mean(0, keepdim=True)
    src, tar = src - c1, tar - c2
    box = C.box_corners(tar[None])[0]
    return dict(src=src, tar=tar, neis_src=(neis[0] - c1).reshape(-1, 9),
                neis_tar=(neis[1] - c2).reshape(-1, 9),
                radius=torch.linalg.vector_norm(box[0] - box[-1]), center=tar.mean(0))


def start_twist(gen):
    """0.001 times a random unit axis, then 0.001 * N(0, 1) translation."""
    axis = torch.randn(3, generator=gen, device=gen.device)
    axis = axis / torch.linalg.vector_norm(axis)
    trans = torch.randn(3, generator=gen, device=gen.device) * 0.001
    return torch.cat([0.001 * axis, trans])


def epoch(s, data, params, count, mu, nu, src_prev, u4):
    """One epoch -> (params, count, mu, nu, moved source, loss, chamfer,
    valid)."""
    lines = C.resample(u4[None], data["radius"][None], data["center"][None], s["n_lines"],
                       src_prev[None], data["tar"][None])[0]
    p = params.detach().requires_grad_(True)
    R, t = C.exp_twist(p)
    loss, valid = C.rigid_loss(R, t, data["neis_src"], data["neis_tar"], lines,
                               s["kmin"], s["kmax"])
    loss, valid = loss[0], valid[0]
    (grads,) = torch.autograd.grad(loss, p, allow_unused=True)
    with torch.no_grad():
        grads = torch.zeros_like(p) if grads is None else grads
        moved = C.mm(data["src"], R) + t
        lr = s["lr"] * 0.5 ** (1 + count // s["lr_halve_every"])
        params, count, mu, nu = C.adam(lr, torch.where(valid, grads, 0.0), count, mu, nu,
                                       params, valid)
        cham = C.chamfer(moved[None], data["tar"][None])
    return params, count, mu, nu, moved, loss.detach(), cham, valid


def follow(src, tar, s, epochs: int, device):
    """The first ``epochs`` epochs of a registration of src onto tar (host
    arrays (N, 3)) with the settings ``s`` (n_lines, num_sample, lr,
    lr_halve_every, kmin, kmax, seed): per epoch its loss, chamfer and
    validity, as lists of floats and bools, and the twist after the last
    (``params``, a list of 6 floats)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(s["seed"])
    data = prepare(torch.as_tensor(src, device=device), torch.as_tensor(tar, device=device),
                   s["num_sample"])
    params = start_twist(gen)
    count = torch.zeros((), dtype=torch.int32, device=device)
    mu, nu = torch.zeros_like(params), torch.zeros_like(params)
    moved = data["src"]
    out = dict(loss=[], chamfer=[], valid=[])
    for _ in range(epochs):
        u4 = torch.rand((4, C.ROUNDS * s["n_lines"]), generator=gen, device=device)
        params, count, mu, nu, moved, loss, cham, valid = epoch(
            s, data, params, count, mu, nu, moved, u4)
        out["loss"].append(float(loss))
        out["chamfer"].append(float(cham))
        out["valid"].append(bool(valid))
    out["params"] = params.cpu().reshape(-1).tolist()
    return out
