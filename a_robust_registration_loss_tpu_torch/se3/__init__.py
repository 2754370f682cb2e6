"""One SE(3)/SO(3)/sinc Lie-algebra library: the port of the JAX package's
``se3/``, with the same names re-exported here."""

from a_robust_registration_loss_tpu_torch.se3 import se3, sinc, so3  # noqa: F401
from a_robust_registration_loss_tpu_torch.se3.se3 import (  # noqa: F401
    exp,
    exp3,
    inverse,
    log,
    rt_concatenate,
    rt_identity,
    rt_inverse,
    rt_transform,
    transform,
)
