"""Evaluation metrics (port of ``leastereo_tpu/train/metrics.py``; reference
``utils/metrics.py``). Each returns a 0-d tensor."""

from __future__ import annotations

import torch

from .losses import validity_mask

__all__ = ["epe", "three_px_error", "bad_pixel_frac"]


def _valid_count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum().clamp(min=1)


def epe(pred: torch.Tensor, target: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Mean absolute disparity error over valid pixels."""
    mask = validity_mask(target, maxdisp)
    return ((pred - target).abs() * mask).sum() / _valid_count(mask)


def three_px_error(pred: torch.Tensor, target: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Fraction of valid pixels wrong by >=3px AND >=5% of GT
    (reference utils/metrics.py:11-21)."""
    mask = validity_mask(target, maxdisp)
    diff = (pred - target).abs()
    correct = ((diff < 3) | (diff < target * 0.05)) & mask
    return 1.0 - correct.sum() / _valid_count(mask)


def bad_pixel_frac(pred: torch.Tensor, target: torch.Tensor, maxdisp: int, threshold: float) -> torch.Tensor:
    """Fraction of valid pixels with |err| > threshold
    (reference utils/metrics.py:37-46)."""
    mask = validity_mask(target, maxdisp)
    correct = ((pred - target).abs() <= threshold) & mask
    return 1.0 - correct.sum() / _valid_count(mask)
