"""Operation and byte counts of the port's two hand-written kernels, frozen
here so that a later change to the program cannot move the yardstick.

Each fp32 multiply and each add counts as one operation (the kernels are
built without fused multiply-adds). The counts are of the work the inputs
need, whatever implements it.

- Stage 1 (``csrc/intersect.cu``): for every (line, neighbourhood) pair, 3
  points x 16 operations: the difference to the line's point (3), its
  squared length (5), the projection on the direction (5), the squared
  distance and the comparison (3). Bytes: the lines, the neighbourhoods
  and their thresholds read once, each line's count, slot indices and
  slot points written once.
- The resampler (``csrc/resample.cu``): per candidate 46 operations to make
  it (two sphere points, the direction) and 81 a triangle for the 12
  triangles of the target's box; the source's box is tested only for the
  candidates that pass the target's (``hits2``). Bytes: 4 uniforms read and
  a line (6) and a flag written per candidate.
"""

STAGE1_OPS_PER_PAIR = 48
RESAMPLE_OPS_MAKE = 46
RESAMPLE_OPS_TRIANGLE = 81
BOX_TRIANGLES = 12
NNEI = 3


def stage1(batch: int, lines: int, faces1: int, faces2: int, kmax: int = 4):
    """(operations, bytes) of one launch of stage 1 over both clouds of
    ``batch`` samples, in the mode that returns the slot points."""
    ops = batch * lines * (faces1 + faces2) * STAGE1_OPS_PER_PAIR
    read = batch * (lines * 6 + (faces1 + faces2) * (3 * NNEI + 1)) * 4
    written = batch * 2 * lines * (1 + kmax + kmax * NNEI * 3) * 4
    return ops, read + written


def resample(batch: int, candidates: int, hits2: float):
    """(operations, bytes) of one resampler launch over ``batch`` samples of
    ``candidates`` candidates each, ``hits2`` of all of them (summed over
    the batch) passing the target's box."""
    tri = BOX_TRIANGLES * RESAMPLE_OPS_TRIANGLE
    ops = batch * candidates * (RESAMPLE_OPS_MAKE + tri) + hits2 * tri
    nbytes = batch * candidates * (4 * 4 + 6 * 4 + 1)
    return ops, nbytes
