"""Training losses (port of ``leastereo_tpu/train/losses.py``; reference
``train.py:116-160``, ``edge_detection/edge_detection.py``).

Disparity maps are ``(B, H, W)``; every loss is a mean over the valid pixels
of the target.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "validity_mask",
    "smooth_l1",
    "masked_smooth_l1",
    "sobel_gradients",
    "gradient_aware_loss",
    "edge_aware_smoothness_loss",
]


def validity_mask(target: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """0.001 < d < maxdisp; zeros are occlusions (reference utils/metrics.py:6-8,
    train.py:116-118)."""
    return (target > 0.001) & (target < maxdisp)


def smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    a = diff.abs()
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def _masked_mean(loss: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (loss * mask).sum() / mask.sum().clamp(min=1)


def masked_smooth_l1(pred: torch.Tensor, target: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Mean smooth-L1 over valid pixels: ``F.smooth_l1_loss(disp[mask],
    target[mask])`` of the reference (train.py:148-156) without the gather."""
    return _masked_mean(smooth_l1(pred - target), validity_mask(target, maxdisp))


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def sobel_gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel x/y gradients of a ``(B, H, W)`` map, zero-padded by 1
    (reference edge_detection.py:32-57)."""
    kx = torch.tensor(_SOBEL_X, dtype=x.dtype, device=x.device)
    k = torch.stack([kx, kx.T])[:, None]  # (2, 1, 3, 3): x then y
    g = F.conv2d(x[:, None], k, padding=1)
    return g[:, 0], g[:, 1]


def gradient_aware_loss(pred: torch.Tensor, target: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Smooth-L1 between prediction and GT Sobel gradients
    (reference edge_detection.py:60-65), masked by validity."""
    px, py = sobel_gradients(pred)
    tx, ty = sobel_gradients(target)
    return _masked_mean(smooth_l1(px - tx) + smooth_l1(py - ty), validity_mask(target, maxdisp))


def edge_aware_smoothness_loss(pred: torch.Tensor, target: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """|grad pred| * exp(-|grad GT|) (reference edge_detection.py:68-74)."""
    px, py = sobel_gradients(pred)
    tx, ty = sobel_gradients(target)
    loss = px.abs() * torch.exp(-tx.abs()) + py.abs() * torch.exp(-ty.abs())
    return _masked_mean(loss, validity_mask(target, maxdisp))
