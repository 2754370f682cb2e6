"""PyTorch/CUDA port of the robust intersected-line registration system.

A second package beside ``a_robust_registration_loss_tpu`` (the JAX
reference, which it never imports). Module names mirror the JAX package.
Plain tensor code is PyTorch; the two hot kernels of the classical
registration step (the paired stage-1 sweep and the line-candidate
resampler) are CUDA C++ under ``csrc/``, built on first use by
``ops/cuda/_build.py``. Every kernel wrapper runs its plain PyTorch version
for a CPU tensor and launches the kernel for a CUDA tensor.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; an
entry point that finds no GPU raises (see ``_device.py``).
"""

from a_robust_registration_loss_tpu_torch import _device  # noqa: F401  (fp32 policy)
