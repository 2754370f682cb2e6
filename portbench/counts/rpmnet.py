"""The floating-point operations of RPM-Net's matrix products at a cell's
shapes, and the bytes of the gather kernel's launch, frozen here so that a
later change to the program cannot move the yardstick. A product of (M, K)
by (K, N) counts 2 M N K, as ``torch.utils.flop_counter.FlopCounterMode``
counts it; the elementwise work (GroupNorm, the PPF angles, Sinkhorn, the
metric's glue) and the monitors are not counted, so a share of the peak
made from these counts is a floor.

The backward of a product computes the gradient of each operand that
needs one, each as many operations as the forward: the first layer of
each net (its input is data: the points, their normals and the source
moved by a detached transform), the Sinkhorn matrix's product with the
target and the Kabsch translation have one where a parameter lies behind
one operand only; the ball queries' distances, the detached moves of the
source and the loss's moves of the clouds (data, or values without a
gradient) have none.
"""

from __future__ import annotations

from portbench.counts import dcp as CD
from portbench.reference import rpmnet as RR


def products(m: dict, B: int, N: int, num_iter: int, F: int = None, loss: bool = True):
    """[(forward operations, backward multiple), ...] of a forward at
    ``num_iter`` iterations of a batch of B pairs of N points, and with
    ``loss`` the training loss's moves, F neighbourhoods a cloud."""
    F = N if F is None else F
    ns = m["num_neighbors"]
    pre, post = RR.feature_layers(m)
    out = []
    for i in range(num_iter):
        for j, (cin, cout, _) in enumerate(RR.ANNEAL_PRE):  # over both clouds' 2N points
            out.append((2 * B * 2 * N * cin * cout, 1 if j == 0 else 2))
        out += [(2 * B * cin * cout, 2) for cin, cout, _ in RR.ANNEAL_POST]
        for _ in range(2):  # the features of the source as moved, then of the target
            out.append((2 * B * N * N * 3, 0))  # the ball query's distances
            out += [(2 * B * N * ns * cin * cout, 1 if j == 0 else 2)
                    for j, (cin, cout, _) in enumerate(pre)]
            out += [(2 * B * N * cin * cout, 2) for cin, cout, _ in post]
        out += [(2 * B * N * N * m["feat_dim"], 2),  # the feature distances
                (2 * B * N * N * 3, 1),              # the Sinkhorn matrix on the target
                (2 * B * 3 * N * 3, 2),              # the covariance
                (2 * B * 27, 2), (2 * B * 27, 2),    # R = +-V U^T
                (2 * B * 9, 2)]                      # t = -R c_a + c_b
        if i < num_iter - 1:
            out += [(2 * B * N * 9, 0)] * 2          # the source and its normals moved
    if loss:
        out.append((2 * B * N * 9, 0))               # the source as predicted, for the lines
        out += [(2 * B * 3 * F * 9, 0)] * num_iter   # its neighbourhoods moved, for stage 1
    return out


def forward(m: dict, B: int, N: int, num_iter: int) -> int:
    """Operations of a forward of a batch without the loss (a test step)."""
    return sum(f for f, _ in products(m, B, N, num_iter, loss=False))


def train_step(m: dict, B: int, N: int, F: int = None) -> int:
    """Operations of a training step: the forward and loss at the training
    iterations, and the backward (each iteration's 3 x 3 SVD backward
    among them)."""
    n = m["num_train_reg_iter"]
    return (sum(f * (1 + b) for f, b in products(m, B, N, n, F))
            + n * CD.SVD_BACKWARD * 2 * B * 27)


def gather_bytes(B: int, N: int, ns: int, C: int = 6, index_bytes: int = 8) -> int:
    """Bytes of one launch of the gather kernel's forward for a feature
    pass, each input read once and the output written once: the (B, N, C)
    table of xyz and normals, the (B, N * ns) index and the (B, N * ns, C)
    rows gathered (a table row is read again by each of its neighbours,
    from the cache)."""
    Q = N * ns
    return B * N * C * 4 + B * Q * index_bytes + B * Q * C * 4
