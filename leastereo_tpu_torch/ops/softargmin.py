"""Disparity regression (port of ``leastereo_tpu/ops/softargmin.py``).

Reference semantics (``models/build_model_2d.py:27-57``): the 1-channel cost
``(B, D, h, w)`` is trilinearly upsampled 3x with ``align_corners=False``,
softmin'd over the ``3D`` disparity planes and reduced to ``sum_d d * p(d)``.

``soft_argmin`` is the plain version of both CUDA heads
(``ops/fused_softargmin.py``, ``ops/fused_head.py``) and their backward.
The cost tensors here are ``(B, D, h, w)``: the JAX functions take the same
data as ``(B, D, h, w, 1)``.
"""

from __future__ import annotations

import torch

from .resize import resize2d, upsample3x_axis

__all__ = ["soft_argmin", "soft_argmin_fast", "disparity_entropy"]


def _math_dtype(x: torch.Tensor) -> torch.Tensor:
    """float32 math, except that a float64 input stays float64 (the on-card
    checks hold the kernels against a float64 evaluation of this code)."""
    return x if x.dtype == torch.float64 else x.float()


def soft_argmin(cost: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Exact-parity disparity regression, ``(B, D, h, w) -> (B, 3h, 3w)``.

    The 3x upsample is phase-decomposed (``softargmin.py:43-90`` of the JAX
    package): H and W are upsampled on the cost, then the three disparity
    phases ``a0 = (c[d-1] + 2c[d])/3``, ``a1 = c[d]``, ``a2 = (2c[d] + c[d+1])/3``
    (edge-clamped) go through a min-stabilised softmin and the expectation,
    so the ``(B, 3D, 3h, 3w)`` volume never exists.
    """
    dn = cost.shape[1]
    if maxdisp != 3 * dn:
        raise ValueError(f"maxdisp {maxdisp} != 3 * D ({dn})")
    x = _math_dtype(cost)
    x = upsample3x_axis(x, 2)
    x = upsample3x_axis(x, 3)  # (B, D, 3h, 3w)
    xm1 = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    xp1 = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    third = 1.0 / 3.0
    a0 = (xm1 + 2.0 * x) * third
    a1 = x
    a2 = (2.0 * x + xp1) * third
    m = torch.minimum(torch.minimum(a0, a1), a2).amin(dim=1, keepdim=True)
    e0 = torch.exp(m - a0)
    e1 = torch.exp(m - a1)
    e2 = torch.exp(m - a2)
    i3 = 3.0 * torch.arange(dn, dtype=x.dtype, device=x.device).view(1, dn, 1, 1)
    den = (e0 + e1 + e2).sum(dim=1)
    num = (i3 * e0 + (i3 + 1.0) * e1 + (i3 + 2.0) * e2).sum(dim=1)
    return num / den


def soft_argmin_fast(cost: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Fast serving head: softmin at feature resolution, ``3 * E + 1`` for the
    disparity-axis upsample, then a bilinear 3x spatial upsample
    (``softargmin.py:93-115`` of the JAX package)."""
    b, d, h, w = cost.shape
    x = _math_dtype(cost)
    p = torch.softmax(-x, dim=1)
    disp = torch.arange(d, dtype=x.dtype, device=x.device).view(1, d, 1, 1)
    low = (p * disp).sum(dim=1) * (maxdisp / d) + 1.0  # (B, h, w)
    return resize2d(low[:, None], (3 * h, 3 * w), align_corners=False)[:, 0]


def disparity_entropy(cost: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Per-pixel softmin-normalised entropy of the disparity distribution, a
    confidence map (reference ``DispEntropy``, ``models/build_model_2d.py:11-24``,
    as in ``softargmin.py:118-138`` of the JAX package): trilinear 3x upsample,
    entropy of the softmax over disparities (NaN masked to 0), then a softmin
    of the ``(B, 3h, 3w)`` map over its rows."""
    if maxdisp != 3 * cost.shape[1]:
        raise ValueError(f"maxdisp {maxdisp} != 3 * D ({cost.shape[1]})")
    x = _math_dtype(cost)
    x = upsample3x_axis(x, 1)
    x = upsample3x_axis(x, 2)
    x = upsample3x_axis(x, 3)
    logp = torch.log_softmax(x, dim=1)
    e = -(logp.exp() * logp).sum(dim=1)
    e = torch.where(torch.isnan(e), torch.zeros_like(e), e)
    return torch.softmax(-e, dim=1)
