"""Operations and bytes of the work, counted on the reference and on the
shapes alone, never on what the program launches; and the card's peaks."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .model import Reference

__all__ = ["PEAK_BF16_FLOPS", "PEAK_HBM_BYTES", "frame_flops", "step_flops", "head_least_s"]

# One NVIDIA H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _reference(cfg: dict) -> Reference:
    with torch.device("meta"):
        return Reference(cfg)


def frame_flops(cfg: dict, batch: int, height: int, width: int) -> int:
    """Floating-point operations of one forward of the reference on
    ``batch`` frames of ``height x width`` (the counter's registered ops:
    convolutions and matrix products), counted on meta tensors."""
    ref = _reference(cfg).eval()
    x = torch.empty(batch, height, width, 3, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(x, x)
    return counter.get_total_flops()


def step_flops(cfg: dict, batch: int, height: int, width: int) -> int:
    """Operations of one train step of the reference: the train-mode
    forward, the loss and the backward."""
    ref = _reference(cfg).train()
    x = torch.empty(batch, height, width, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref(x, x).sum().backward()
    return counter.get_total_flops()


def head_least_s(b: int, c: int, d: int, h: int, w: int, volume_bytes: int, weight_bytes: int) -> float:
    """The least time of the fused head (``last_3`` 3x3x3 conv, C -> 1,
    then the 3x upsample, softmin and regression) on a ``(b, c, d, h, w)``
    volume: the larger of its FLOPs (2 * 27 * C per voxel) over the bf16
    peak and its bytes (the volume read once, the ``last_3`` weights, the
    ``(b, 3h, 3w)`` float32 map written once) over HBM's bandwidth."""
    flops = 2 * 27 * c * b * d * h * w
    nbytes = b * c * d * h * w * volume_bytes + 27 * c * weight_bytes + b * 9 * h * w * 4
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
