"""Concat feature volume (port of ``leastereo_tpu/ops/cost_volume.py``).

Reference semantics (``retrain/LEAStereo.py:30-48``): a zero-initialised
volume over candidate disparities ``d`` in ``[0, num_disp)``; at disparity
``d`` the left features sit at columns ``w >= d`` and the right features are
shifted right by ``d``. Columns ``w < d`` stay zero in both halves.
"""

from __future__ import annotations

import torch

__all__ = ["build_cost_volume"]


def build_cost_volume(
    left: torch.Tensor, right: torch.Tensor, num_disp: int, planes: tuple[int, int] | None = None
) -> torch.Tensor:
    """``left``, ``right``: NCHW ``(B, C, H, W)`` features. Returns the NCDHW
    volume ``(B, 2C, num_disp, H, W)`` with ``vol[:, :C, d, :, w] = left[..., w]``
    and ``vol[:, C:, d, :, w] = right[..., w - d]`` for ``w >= d``, zero
    elsewhere. ``planes=(lo, hi)``: only planes ``lo <= d < hi`` of it, those
    outside ``[0, num_disp)`` zero (a rank's slab of a disparity-sharded
    volume with its halo planes)."""
    b, c, h, w = left.shape
    lo, hi = (0, num_disp) if planes is None else planes
    vol = left.new_zeros((b, 2 * c, hi - lo, h, w))
    for d in range(max(lo, 0), min(hi, num_disp, w)):
        vol[:, :c, d - lo, :, d:] = left[..., d:]
        vol[:, c:, d - lo, :, d:] = right[..., : w - d]
    return vol
