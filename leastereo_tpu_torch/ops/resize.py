"""Interpolation ops (port of ``leastereo_tpu/ops/resize.py``).

The JAX package rebuilds PyTorch's ``F.interpolate`` semantics from dense
interpolation matrices; here ``F.interpolate`` itself is the semantics. Every
resize passes an explicit output size, so no scale-factor rounding enters.
Layouts are NCHW (2-D) and NCDHW (3-D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["scale_dimension", "resize2d", "resize3d", "upsample3x_axis"]


def scale_dimension(dim: int, scale: float) -> int:
    """Reference's odd-dimension-aware scaling rule
    (``retrain/new_model_2d.py:38-39``): odd dims map ``d -> (d-1)*s + 1`` so
    align_corners=True resizing stays on the corner grid; even dims map
    ``d -> int(d*s)``."""
    return int((float(dim) - 1.0) * scale + 1.0) if dim % 2 == 1 else int(float(dim) * scale)


def resize2d(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``out_hw``."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners)


def resize3d(x: torch.Tensor, out_dhw: tuple[int, int, int], align_corners: bool = True) -> torch.Tensor:
    """Trilinear resize of an NCDHW tensor to ``out_dhw``."""
    if tuple(x.shape[2:]) == tuple(out_dhw):
        return x
    return F.interpolate(x, size=tuple(out_dhw), mode="trilinear", align_corners=align_corners)


def upsample3x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 3x linear upsample along ``axis`` (align_corners=False).

    Output position ``3i + r`` has source ``i + (r-1)/3``: phase 0 blends
    ``x[i-1]`` and ``x[i]`` 1/3 : 2/3, phase 1 is ``x[i]``, phase 2 blends
    ``x[i]`` and ``x[i+1]`` 2/3 : 1/3, with edge clamping.
    """
    axis = axis % x.ndim
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    r0 = (1.0 / 3.0) * prev + (2.0 / 3.0) * x
    r2 = (2.0 / 3.0) * x + (1.0 / 3.0) * nxt
    out = torch.stack([r0, x, r2], dim=axis + 1)
    return out.reshape(*x.shape[:axis], 3 * n, *x.shape[axis + 1 :])
