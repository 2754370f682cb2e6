"""Carry the JAX package's DCP, FMR and RPM-Net weights and Adam state into
the port, and read a reference PyTorch checkpoint.

``dcp_from_flax`` turns the JAX package's DCP parameter tree (a nested dict
of numpy arrays, ``model.init(...)["params"]`` or a restored checkpoint)
into a ``state_dict`` for the port's ``models.dcp.DCP``. It is the inverse
of the name map in ``a_robust_registration_loss_tpu/models/transplant.py:
dcp_from_state_dict``; the port's names are the reference PyTorch DCP's.
``fmr_from_flax`` does the same for FMR's ``SolveRegistration``, the
inverse of ``fmr_from_state_dict`` there, and ``rpmnet_from_flax`` for
RPM-Net's ``RPMNetEarlyFusion``, the inverse of ``rpmnet_from_state_dict``
there. ``adam_from_optax`` carries an optax Adam state over any of these
trees into the port's ``ops.adam.AdamState`` (flat, as ``train.harness``
steps it) through the same map, with the schedule's own count where the
optimiser is ``optax.adam(schedule)``. ``load_torch_state_dict`` reads a
reference ``.pth`` for ``load_state_dict``; ``rpmnet_from_state_dict``
cuts a reference RPM-Net's to the port's parameters.

Layouts: a Dense kernel (in, out) transposes into a weight (out, in), with
the trailing 1s of a pointwise convolution appended for the embedding nets
((out, in, 1) for PointNet, (out, in, 1, 1) for DGCNN, told apart by the
first layer's 3 or 6 input channels); a GroupNorm's scale and bias become
weight and bias; a LayerNorm's a and b become a_2 and b_2; FeedForward's
``Dense_0`` is the outer ``w_2`` and ``Dense_1`` the inner ``w_1``.
"""

from __future__ import annotations

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch.ops.adam import AdamState, ScheduledAdamState


class _Tree:
    """Reads leaves of a nested dict by path and remembers which were read,
    so that a missing key raises and the unread ones can be listed."""

    def __init__(self, params):
        self.leaves = {}
        self._flatten(params, ())
        self.used = set()

    def _flatten(self, node, path):
        if hasattr(node, "items"):
            for k, v in node.items():
                self._flatten(v, path + (str(k),))
        else:
            self.leaves["/".join(path)] = np.asarray(node)

    def has(self, prefix: str) -> bool:
        return any(k == prefix or k.startswith(prefix + "/") for k in self.leaves)

    def take(self, path: str):
        if path not in self.leaves:
            raise KeyError(f"missing parameter {path!r}")
        self.used.add(path)
        return torch.tensor(self.leaves[path], dtype=torch.float32)

    def unused(self):
        return sorted(set(self.leaves) - self.used)


def dcp_from_flax(params) -> dict:
    """JAX-package DCP params -> the port's DCP ``state_dict``. Covers every
    configuration: pointnet / dgcnn, identity / transformer (any number of
    blocks), svd / mlp. Raises ``KeyError`` on a missing parameter and on
    one that no module of the port takes."""
    tree = _Tree(params)
    sd = {}

    def dense(src, dst, bias=True, ones=0):
        w = tree.take(f"{src}/kernel").T.contiguous()
        sd[f"{dst}.weight"] = w.reshape(w.shape + (1,) * ones)
        if bias:
            sd[f"{dst}.bias"] = tree.take(f"{src}/bias")

    def groupnorm(src, dst):
        sd[f"{dst}.weight"] = tree.take(f"{src}/GroupNorm_0/scale")
        sd[f"{dst}.bias"] = tree.take(f"{src}/GroupNorm_0/bias")

    def layernorm(src, dst):
        sd[f"{dst}.a_2"] = tree.take(f"{src}/a")
        sd[f"{dst}.b_2"] = tree.take(f"{src}/b")

    def attention(src, dst):
        for i, name in enumerate(("wq", "wk", "wv", "wo")):
            dense(f"{src}/{name}", f"{dst}.linears.{i}")

    first = tree.leaves.get("emb_nn/Dense_0/kernel")
    if first is None:
        raise KeyError("dcp_from_flax: missing parameter 'emb_nn/Dense_0/kernel'")
    ones = {3: 1, 6: 2}.get(first.shape[0])  # pointnet Conv1d / dgcnn Conv2d
    if ones is None:
        raise KeyError(f"dcp_from_flax: emb_nn/Dense_0/kernel takes {first.shape[0]} "
                       "channels, neither pointnet's 3 nor dgcnn's 6")
    for i in range(5):
        dense(f"emb_nn/Dense_{i}", f"emb_nn.conv{i + 1}", bias=False, ones=ones)
        groupnorm(f"emb_nn/TorchGroupNorm_{i}", f"emb_nn.bn{i + 1}")

    if tree.has("head"):  # the MLP head; the SVD head has no parameters
        for j in range(3):
            dense(f"head/Dense_{j}", f"head.nn.{3 * j}")
            groupnorm(f"head/TorchGroupNorm_{j}", f"head.nn.{3 * j + 1}")
        dense("head/Dense_3", "head.proj_rot")
        dense("head/Dense_4", "head.proj_trans")
    else:
        sd["head.reflect"] = torch.diag(torch.tensor([1.0, 1.0, -1.0]))

    if tree.has("pointer"):
        n_blocks = 0
        while tree.has(f"pointer/enc{n_blocks}"):
            n_blocks += 1
        for i in range(n_blocks):
            for stack, norms in (("enc", 2), ("dec", 3)):
                src = f"pointer/{stack}{i}"
                dst = f"pointer.model.{stack}oder.layers.{i}"
                attention(f"{src}/MultiHeadAttention_0", f"{dst}.self_attn")
                if stack == "dec":
                    attention(f"{src}/MultiHeadAttention_1", f"{dst}.src_attn")
                dense(f"{src}/FeedForward_0/Dense_0", f"{dst}.feed_forward.w_2")
                dense(f"{src}/FeedForward_0/Dense_1", f"{dst}.feed_forward.w_1")
                for k in range(norms):
                    layernorm(f"{src}/TorchLayerNorm_{k}", f"{dst}.sublayer.{k}.norm")
        layernorm("pointer/enc_norm", "pointer.model.encoder.norm")
        layernorm("pointer/dec_norm", "pointer.model.decoder.norm")

    if tree.unused():
        raise KeyError(f"dcp_from_flax: parameters no module takes: {tree.unused()}")
    return sd


def fmr_from_flax(params) -> dict:
    """JAX-package FMR ``SolveRegistration`` params -> the port's
    ``state_dict``: ``encoder/Dense_{0..4}`` to ``encoder.h1.{0,3}`` and
    ``encoder.h2.{0,3,6}`` ((out, in, 1) weights and biases), their
    GroupNorms to the next index, ``decoder/Dense_{0..3}`` to
    ``decoder.fc{1..4}``, ``decoder/TorchGroupNorm_{0..2}`` to
    ``decoder.bn{1..3}``, and ``dt``. A tree without a decoder gives a
    state dict without one. Raises ``KeyError`` on a missing parameter and
    on one that no module of the port takes."""
    tree = _Tree(params)
    sd = {}

    def dense(src, dst, ones=0):
        w = tree.take(f"{src}/kernel").T.contiguous()
        sd[f"{dst}.weight"] = w.reshape(w.shape + (1,) * ones)
        sd[f"{dst}.bias"] = tree.take(f"{src}/bias")

    def groupnorm(src, dst):
        sd[f"{dst}.weight"] = tree.take(f"{src}/GroupNorm_0/scale")
        sd[f"{dst}.bias"] = tree.take(f"{src}/GroupNorm_0/bias")

    for i, (block, li) in enumerate([("h1", 0), ("h1", 3), ("h2", 0), ("h2", 3), ("h2", 6)]):
        dense(f"encoder/Dense_{i}", f"encoder.{block}.{li}", ones=1)
        groupnorm(f"encoder/TorchGroupNorm_{i}", f"encoder.{block}.{li + 1}")
    if tree.has("decoder"):
        for i in range(4):
            dense(f"decoder/Dense_{i}", f"decoder.fc{i + 1}")
        for i in range(3):
            groupnorm(f"decoder/TorchGroupNorm_{i}", f"decoder.bn{i + 1}")
    sd["dt"] = tree.take("dt").reshape(1, 6)
    if tree.unused():
        raise KeyError(f"fmr_from_flax: parameters no module takes: {tree.unused()}")
    return sd


def rpmnet_from_flax(params) -> dict:
    """JAX-package ``RPMNetEarlyFusion`` params -> the port's
    ``state_dict``: ``weights_net/Dense_{0..4}`` to ``weights_net.prepool.
    {0,3,6,9,12}`` ((out, in, 1) weights), ``Dense_{5,6,7}`` to
    ``weights_net.postpool.{0,3,6}``, each GroupNorm to the next index (or
    ``weights_net/anneal_weights`` alone, the constant variant);
    ``feat_extractor/Dense_{0..2}`` to ``feat_extractor.prepool.{0,3,6}``
    ((out, in, 1, 1)) and ``Dense_{3..5}`` to ``feat_extractor.postpool.
    {0,3,6}`` ((out, in, 1)), GroupNorms likewise. Raises ``KeyError`` on a
    missing parameter and on one that no module of the port takes."""
    tree = _Tree(params)
    sd = {}

    def dense(src, dst, ones=0):
        w = tree.take(f"{src}/kernel").T.contiguous()
        sd[f"{dst}.weight"] = w.reshape(w.shape + (1,) * ones)
        sd[f"{dst}.bias"] = tree.take(f"{src}/bias")

    def groupnorm(src, dst):
        sd[f"{dst}.weight"] = tree.take(f"{src}/GroupNorm_0/scale")
        sd[f"{dst}.bias"] = tree.take(f"{src}/GroupNorm_0/bias")

    def stack(src, dst, first, layers, ones, norms):
        for j in range(layers):
            dense(f"{src}/Dense_{first + j}", f"{dst}.{3 * j}", ones)
            if j < norms:
                groupnorm(f"{src}/TorchGroupNorm_{first + j}", f"{dst}.{3 * j + 1}")

    if tree.has("weights_net/anneal_weights"):
        sd["weights_net.anneal_weights"] = tree.take("weights_net/anneal_weights").reshape(2)
    else:
        stack("weights_net", "weights_net.prepool", 0, 5, 1, 5)
        stack("weights_net", "weights_net.postpool", 5, 3, 0, 2)
    stack("feat_extractor", "feat_extractor.prepool", 0, 3, 2, 3)
    stack("feat_extractor", "feat_extractor.postpool", 3, 3, 1, 2)
    if tree.unused():
        raise KeyError(f"rpmnet_from_flax: parameters no module takes: {tree.unused()}")
    return sd


def rpmnet_from_state_dict(sd) -> dict:
    """A reference RPM-Net ``state_dict`` (its own names and shapes:
    ``Conv1d`` weights (O, I, 1), ``Conv2d`` (O, I, 1, 1)) -> the port's:
    the annealing net's last ``Linear`` (``weights_net.postpool.6``) and the
    constant variant's ``weights_net.anneal_weights`` hold 2 +
    prod(weights_dim) values of which the reference reads the first 2, and
    only those are kept. Every other entry passes unchanged; the constant
    variant is told apart by its ``anneal_weights`` key, and a model built
    for the other variant refuses the result in ``load_state_dict``."""
    out = dict(sd)
    if "weights_net.anneal_weights" in out:
        out["weights_net.anneal_weights"] = out["weights_net.anneal_weights"].reshape(-1)[:2]
    for key in ("weights_net.postpool.6.weight", "weights_net.postpool.6.bias"):
        if key in out:
            out[key] = out[key][:2]
    return out


def adam_from_optax(opt_state, names, from_flax=dcp_from_flax):
    """An optax Adam state over a JAX parameter tree -> the port's for the
    parameters ``names`` (in the order of ``model.named_parameters()``).

    opt_state: ``optax.adam(lr)``'s ``ScaleByAdamState`` (count, mu, nu),
    the count a scalar and each moment a tree keyed like the Flax
    parameters, as numpy arrays -> ``ops.adam.AdamState``; or
    ``optax.adam(schedule)``'s chain state (that triple,
    ``ScaleByScheduleState`` (count,)) -> ``ops.adam.ScheduledAdamState``,
    Adam's count and the schedule's each kept. The moments go through
    ``from_flax``'s name map (``dcp_from_flax``, ``fmr_from_flax`` or
    ``rpmnet_from_flax``: it is linear, so it carries them as it carries
    the weights) and are flattened and concatenated in ``names``' order."""
    if len(opt_state) == 2:
        adam_state, (schedule_count,) = opt_state
        return ScheduledAdamState(adam_from_optax(adam_state, names, from_flax),
                                  torch.tensor(np.asarray(schedule_count, np.int32)).reshape(()))
    count, mu, nu = opt_state
    mu, nu = from_flax(mu), from_flax(nu)
    return AdamState(torch.tensor(np.asarray(count, np.int32)).reshape(()),
                     torch.cat([mu[n].reshape(-1) for n in names]),
                     torch.cat([nu[n].reshape(-1) for n in names]))


def load_torch_state_dict(path: str) -> dict:
    """A reference ``.pth`` / ``.t7`` checkpoint -> a state dict of CPU
    tensors for ``load_state_dict``: the ``{"state_dict": ...}`` container
    some savers use is unwrapped, DataParallel's ``module.`` prefix is
    stripped, and entries that are not tensors (epoch counters, scores) are
    skipped. Raises ``ValueError`` when no tensor is left."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    out = {k.removeprefix("module."): v for k, v in sd.items()
           if isinstance(v, torch.Tensor)}
    if not out:
        raise ValueError(f"{path}: no tensor entries found (keys: {sorted(sd)[:8]}...)")
    return out
