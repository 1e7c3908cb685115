"""Training of the port: losses, metrics, LR schedules, optimizers and the
train and eval steps (port of ``leastereo_tpu/train``)."""

from .losses import (
    edge_aware_smoothness_loss,
    gradient_aware_loss,
    masked_smooth_l1,
    validity_mask,
)
from .metrics import bad_pixel_frac, epe, three_px_error
from .step import eval_step, make_lr_schedule, make_optimizer, train_step

__all__ = [
    "edge_aware_smoothness_loss",
    "gradient_aware_loss",
    "masked_smooth_l1",
    "validity_mask",
    "bad_pixel_frac",
    "epe",
    "three_px_error",
    "eval_step",
    "make_lr_schedule",
    "make_optimizer",
    "train_step",
]
