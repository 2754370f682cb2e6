"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit), the denominators of every roofline and
``mfu`` share the benchmark reports."""

FP32_OPS = 67e12      # fp32 operations a second outside the tensor cores (an FMA counts 2)
HBM_BYTES = 3.35e12   # bytes a second of HBM3


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for ``ops`` fp32 operations and
    ``nbytes`` moved: the larger of the two bounds."""
    return max(ops / FP32_OPS, nbytes / HBM_BYTES)
