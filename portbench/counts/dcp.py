"""The floating-point operations of DCP-v2's matrix products at a cell's
shapes, frozen here so that a later change to the program cannot move the
yardstick. A product of (M, K) by (K, N) counts 2 M N K (a multiply and an
add each), as ``torch.utils.flop_counter.FlopCounterMode`` counts it; the
elementwise work (norms, softmax, the metric's glue) is not counted, so a
share of the peak made from these counts is a floor.

The backward of a product computes the gradient of each operand that
needs one, each as many operations as the forward: the first DGCNN layer
(its input is the data), the correspondences' product with the target
points and the covariance (one data operand each) have one; the products
whose operands both need a gradient have two; the k-NN graph's distances,
the sign test of the SVD head and the loss's moves of the clouds (data,
or values without a gradient) have none.
"""

from __future__ import annotations

# (in, out) of the DGCNN layers; None is the embedding width
DGCNN = ((6, 64), (64, 64), (64, 128), (128, 256), (512, None))


def products(m: dict, B: int, N: int, F: int = None):
    """[(forward operations, backward multiple), ...] of one forward and
    loss of a batch of B pairs of N points, F neighbourhoods a cloud."""
    F = N if F is None else F
    e, ff, k, blocks = m["emb_dims"], m["ff_dims"], m["dgcnn_k"], m["n_blocks"]
    out = []
    for _ in range(2):  # the DGCNN of the source, then of the target
        out.append((2 * B * N * N * 3, 0))
        for i, (cin, cout) in enumerate(DGCNN):
            rows = B * N * (k if i < 4 else 1)
            out.append((2 * rows * cin * (e if cout is None else cout), 1 if i == 0 else 2))
    attn = [(4 * 2 * B * N * e * e, 2), (2 * B * N * N * e, 2), (2 * B * N * N * e, 2)]
    ffn = [(2 * 2 * B * N * e * ff, 2)]
    for _ in range(2):  # src' = Dec(src | Enc(tgt)), tgt' = Dec(tgt | Enc(src))
        out += (attn + ffn) * blocks          # the encoder
        out += (attn + attn + ffn) * blocks   # the decoder
    out += [(2 * B * N * N * e, 2),          # the correspondence scores
            (2 * B * N * N * 3, 1),          # soft correspondences
            (2 * B * 3 * N * 3, 1),          # the covariance H
            (2 * B * 27, 0),                 # V U^T, for the sign of its determinant
            (2 * B * 27, 2),                 # R = V diag(1, 1, d) U^T
            (2 * B * 9, 1),                  # t = -R mean + mean
            (2 * B * N * 9, 0),              # the source as predicted, for the lines
            (2 * B * 3 * F * 9, 0)]          # the source's neighbourhoods moved, for stage 1
    return out


def forward(m: dict, B: int, N: int, F: int = None) -> int:
    """Operations of a forward and loss of a batch (a test pass's step)."""
    return sum(f for f, _ in products(m, B, N, F))


SVD_BACKWARD = 4  # products of 3 x 3 matrices in the backward of a 3 x 3 SVD


def train_step(m: dict, B: int, N: int, F: int = None) -> int:
    """Operations of a training step: the forward and loss, and the backward."""
    return sum(f * (1 + b) for f, b in products(m, B, N, F)) + SVD_BACKWARD * 2 * B * 27
