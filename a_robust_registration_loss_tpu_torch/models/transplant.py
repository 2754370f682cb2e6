"""Carry the JAX package's DCP weights into the port.

``dcp_from_flax`` turns the JAX package's DCP parameter tree (a nested dict
of numpy arrays, ``model.init(...)["params"]`` or a restored checkpoint)
into a ``state_dict`` for the port's ``models.dcp.DCP``. It is the inverse
of the name map in ``a_robust_registration_loss_tpu/models/transplant.py:
dcp_from_state_dict``; the port's names are the reference PyTorch DCP's.

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
            raise KeyError(f"dcp_from_flax: missing parameter {path!r}")
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
