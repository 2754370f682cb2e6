"""Device resolution and the fp32 policy of the port.

The JAX package pins HIGHEST matmul precision on the whole geometry/metric
path (ops/metric.py, ops/geometry.py, se3/se3.py): a rounded rigid
transform moves stage-1 labels and kNN/FPS orderings. The CUDA counterpart
of that pin is TF32 off for matmuls and cuDNN, set here once for the
process when the port is imported.

The opt-in bf16 mode (the models' ``dtype="bfloat16"``) multiplies bf16
operands on the tensor cores. cuBLAS may then reduce the partial sums of a
split-K product in bf16; that is switched off here too, so every bf16
product accumulates in fp32 and is rounded to bf16 once, as the TPU's
matrix unit does and as the JAX package's bf16 products are specified.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def sqrt_rn(x):
    """Correctly rounded fp32 square root on every device. CUDA's sqrt is
    IEEE; PyTorch's vectorised CPU sqrt is not always (on some inputs it
    is one ulp off the rounded result), so the CPU takes it in float64 and
    rounds once, which is exact for a square root. Used where a
    label depends on the last bit (thresholds, barycentric areas)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def resolve(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device that is not there raises: the
    port never carries on on the CPU unless asked to with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
