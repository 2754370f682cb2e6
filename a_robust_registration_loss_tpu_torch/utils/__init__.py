"""Framework utilities: checkpoint management, observability, timing."""

from a_robust_registration_loss_tpu_torch.utils.checkpoint import (  # noqa: F401
    CheckPointManager, load_params_from)
from a_robust_registration_loss_tpu_torch.utils.logging import (  # noqa: F401
    IOStream,
    MetricsWriter,
    prepare_logger,
)
from a_robust_registration_loss_tpu_torch.utils.timing import StepTimer, span, trace  # noqa: F401
