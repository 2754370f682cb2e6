"""Evaluation metrics: the trainers' accuracy oracles."""

from a_robust_registration_loss_tpu_torch.eval import metrics  # noqa: F401
