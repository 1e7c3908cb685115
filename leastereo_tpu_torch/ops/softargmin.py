"""Disparity regression (port of ``leastereo_tpu/ops/softargmin.py``).

Reference semantics (``models/build_model_2d.py:27-57``): the 1-channel cost
``(B, D, h, w)`` is trilinearly upsampled 3x with ``align_corners=False``,
softmin'd over the ``3D`` disparity planes and reduced to ``sum_d d * p(d)``.

``soft_argmin`` is the plain version of both CUDA heads
(``ops/fused_softargmin.py``, ``ops/fused_head.py``) and their backward.
The cost tensors here are ``(B, D, h, w)``: the JAX functions take the same
data as ``(B, D, h, w, 1)``.

``soft_argmin_sharded``, ``soft_argmin_fast_sharded`` and
``disparity_entropy_sharded`` are the plain distributed heads of a
disparity-sharded cost (``parallel/halo.py``): each rank holds a slab of the
D planes, takes its neighbours' ±1 low-res planes for the 3x D upsample
(edges clamped at the global ends only), and the reductions over D are
all_reduces, so every rank ends with the whole ``(B, 3h, 3w)`` map. The JAX
package runs its plain heads there too
(``leastereo_tpu/models/leastereo.py:126,171``). The two soft-argmins are
differentiable (the train step's heads); the entropy is eval-only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.halo import DispPartition, halo
from ..parallel.mesh import all_reduce
from .resize import resize2d, upsample3x_axis

__all__ = [
    "soft_argmin",
    "soft_argmin_fast",
    "disparity_entropy",
    "soft_argmin_sharded",
    "soft_argmin_fast_sharded",
    "disparity_entropy_sharded",
]


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
    a = _phases(xm1, x, xp1)
    m = _phase_min(a)
    num, den = _expectation(a, m, 0)
    return num / den


def _phases(xm1: torch.Tensor, x: torch.Tensor, xp1: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The three disparity phases of the 3x D upsample at each plane."""
    third = 1.0 / 3.0
    return (xm1 + 2.0 * x) * third, x, (2.0 * x + xp1) * third


def _phase_min(a: tuple[torch.Tensor, ...]) -> torch.Tensor:
    return torch.minimum(torch.minimum(a[0], a[1]), a[2]).amin(dim=1, keepdim=True)


def _expectation(a: tuple[torch.Tensor, ...], m: torch.Tensor, lo: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``sum d' e^(m - a)`` and ``sum e^(m - a)`` over the planes of ``a``,
    the first of which is global plane ``lo``."""
    a0, a1, a2 = a
    e0 = torch.exp(m - a0)
    e1 = torch.exp(m - a1)
    e2 = torch.exp(m - a2)
    dn = a1.shape[1]
    i3 = 3.0 * torch.arange(lo, lo + dn, dtype=a1.dtype, device=a1.device).view(1, dn, 1, 1)
    den = (e0 + e1 + e2).sum(dim=1)
    num = (i3 * e0 + (i3 + 1.0) * e1 + (i3 + 2.0) * e2).sum(dim=1)
    return num, den


def _clamped_halo(cost: torch.Tensor, part: DispPartition) -> torch.Tensor:
    """The slab ``(B, n, h, w)`` with one low-res plane of each neighbour on
    either side, as float32; at a global end, the end plane again (the
    upsample's edge clamp)."""
    x = _math_dtype(halo(cost, part, 1, dim=1))
    if part.lo == 0:
        x[:, 0] = x[:, 1]
    if part.hi == part.depth:
        x[:, -1] = x[:, -2]
    return x


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``x`` over ``group`` on every rank. Its adjoint passes
    each rank its own gradient of the sum (the identity): every rank of a
    sharded head holds the same map and computes the same loss from it, so
    that gradient is already the gradient of the loss, counted once. (An
    all_reduce of the gradients, as ``torch.distributed.nn`` does, would
    count it once per rank.)"""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumOverRanks.apply(x, group)


def soft_argmin_sharded(cost: torch.Tensor, part: DispPartition, maxdisp: int) -> torch.Tensor:
    """:func:`soft_argmin` of a cost sharded along D: ``cost`` is rank
    ``part.rank``'s ``(B, n, h, w)`` slab of the ``part.depth`` planes. The
    same fp32 formula; the minimum is an all_reduce MIN and the two sums an
    all_reduce SUM over ``part.group``. Returns the whole ``(B, 3h, 3w)`` map
    on every rank.

    Differentiable: the minimum only stabilises the softmin, which does not
    change when the cost shifts, so it is detached; the sums' adjoint is
    the identity (:class:`_SumOverRanks`), so the gradient a rank's slab
    receives is its share of the gradient of a loss every rank computes
    alike, not ``part.world`` times it."""
    if maxdisp != 3 * part.depth:
        raise ValueError(f"maxdisp {maxdisp} != 3 * D ({part.depth})")
    x = _clamped_halo(cost, part)
    x = upsample3x_axis(x, 2)
    x = upsample3x_axis(x, 3)  # (B, n + 2, 3h, 3w)
    a = _phases(x[:, :-2], x[:, 1:-1], x[:, 2:])
    with torch.no_grad():
        m = all_reduce(_phase_min(a), part.group, dist.ReduceOp.MIN)
    num, den = _expectation(a, m, part.lo)
    num, den = _sum_over_ranks(torch.stack([num, den]), part.group)
    return num / den


def soft_argmin_fast_sharded(cost: torch.Tensor, part: DispPartition, maxdisp: int) -> torch.Tensor:
    """:func:`soft_argmin_fast` of a cost sharded along D (``cost`` as in
    :func:`soft_argmin_sharded`): the softmax over the D planes takes its
    maximum (all_reduce MAX, detached) and its two sums (all_reduce SUM,
    identity adjoint) from every rank. The whole ``(B, 3h, 3w)`` map on
    every rank."""
    _, n, h, w = cost.shape
    x = -_math_dtype(cost)
    with torch.no_grad():
        m = all_reduce(x.amax(dim=1, keepdim=True), part.group, dist.ReduceOp.MAX)
    e = torch.exp(x - m)
    disp = torch.arange(part.lo, part.hi, dtype=x.dtype, device=x.device).view(1, n, 1, 1)
    num, den = _sum_over_ranks(torch.stack([(e * disp).sum(dim=1), e.sum(dim=1)]), part.group)
    low = num / den * (maxdisp / part.depth) + 1.0  # (B, h, w)
    return resize2d(low[:, None], (3 * h, 3 * w), align_corners=False)[:, 0]


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


def disparity_entropy_sharded(cost: torch.Tensor, part: DispPartition, maxdisp: int) -> torch.Tensor:
    """:func:`disparity_entropy` of a cost sharded along D (``cost`` as in
    :func:`soft_argmin_sharded`): the log-softmax over the 3D planes takes
    its maximum (all_reduce MAX) and its normaliser (all_reduce SUM) from
    every rank, and the entropy sums over ranks. The whole ``(B, 3h, 3w)``
    map on every rank."""
    if maxdisp != 3 * part.depth:
        raise ValueError(f"maxdisp {maxdisp} != 3 * D ({part.depth})")
    x = upsample3x_axis(_clamped_halo(cost, part), 1)[:, 3:-3]  # this rank's 3n planes
    x = upsample3x_axis(x, 2)
    x = upsample3x_axis(x, 3)
    m = all_reduce(x.amax(dim=1, keepdim=True), part.group, dist.ReduceOp.MAX)
    s = all_reduce(torch.exp(x - m).sum(dim=1, keepdim=True), part.group)
    logp = x - m - torch.log(s)
    e = all_reduce(-(logp.exp() * logp).sum(dim=1), part.group)
    e = torch.where(torch.isnan(e), torch.zeros_like(e), e)
    return torch.softmax(-e, dim=1)
