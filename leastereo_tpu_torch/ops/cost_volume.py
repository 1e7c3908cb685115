"""Concat feature volume (port of ``leastereo_tpu/ops/cost_volume.py``).

Reference semantics (``retrain/LEAStereo.py:30-48``): a zero-initialised
volume over candidate disparities ``d`` in ``[0, num_disp)``; at disparity
``d`` the left features sit at columns ``w >= d`` and the right features are
shifted right by ``d``. Columns ``w < d`` stay zero in both halves.
"""

from __future__ import annotations

import torch

__all__ = ["build_cost_volume"]


def build_cost_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int) -> torch.Tensor:
    """``left``, ``right``: NCHW ``(B, C, H, W)`` features. Returns the NCDHW
    volume ``(B, 2C, num_disp, H, W)`` with ``vol[:, :C, d, :, w] = left[..., w]``
    and ``vol[:, C:, d, :, w] = right[..., w - d]`` for ``w >= d``, zero
    elsewhere."""
    b, c, h, w = left.shape
    vol = left.new_zeros((b, 2 * c, num_disp, h, w))
    for d in range(min(num_disp, w)):
        vol[:, :c, d, :, d:] = left[..., d:]
        vol[:, c:, d, :, d:] = right[..., : w - d]
    return vol
