"""Band kernel: fused 3x upsample + softmin + soft-argmin on an existing cost.

Port of ``leastereo_tpu/ops/pallas_softargmin.py``. The CUDA kernel
(``csrc/soft_argmin_heads.cu``, ``lst_band_soft_argmin``) replaces the Pallas
``_band_kernel`` (``pallas_softargmin.py:45-98``): the same real-number math
as the plain :func:`~leastereo_tpu_torch.ops.softargmin.soft_argmin`, in one
pass that reads the ``(B, D, h, w)`` cost once and writes the ``(B, 3h, 3w)``
map, where the plain version holds several ``(B, D, 3h, 3w)`` fp32 phase
tensors in device memory.

On the H100 the kernel computes one exponential per low-res plane and output
phase (9D per low-res pixel) and is bound by the instructions its shared
stage issues per pixel and plane, not by its exponentials or its 15.5 MB of
traffic. A block keeps a ``D x (1+2) x (32+2)`` cost tile in shared memory,
loaded with ``cp.async``; each of its 96 threads produces the 3 output phases of one output row of one low-res
pixel in registers, so nothing intermediate leaves the chip. Its shared
memory admits D <= 569.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .softargmin import soft_argmin

__all__ = ["band_gate_reason", "band_soft_argmin", "soft_argmin_cuda", "soft_argmin_fused"]


def band_gate_reason(d: int, maxdisp: int) -> str | None:
    """``None`` when the band kernel takes a ``(B, D, h, w)`` cost; else why not."""
    if maxdisp != 3 * d:
        return f"maxdisp {maxdisp} != 3 * D ({d})"
    if _build.band_smem_bytes(d) > _build.SMEM_LIMIT:
        return f"cost tile needs {_build.band_smem_bytes(d)} B of shared memory > {_build.SMEM_LIMIT}"
    return None


def _check_rank(cost: torch.Tensor) -> None:
    if cost.ndim != 4:
        raise ValueError(f"expected a (B, D, h, w) cost, got shape {tuple(cost.shape)}")


def soft_argmin_cuda(cost: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """``(B, D, h, w)`` cost -> ``(B, 3h, 3w)`` fp32 disparity.

    A CUDA tensor must be fp32 and contiguous and runs the band kernel; a CPU
    tensor takes the plain :func:`soft_argmin`. ``soft_argmin_cuda.launches``
    counts the kernel launches.
    """
    _check_rank(cost)
    if cost.device.type == "cpu":
        return soft_argmin(cost, maxdisp)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    b, d, h, w = cost.shape
    reason = band_gate_reason(d, maxdisp)
    if reason is not None:
        raise ValueError(f"band kernel refuses this cost: {reason}")
    if cost.dtype != torch.float32 or not cost.is_contiguous():
        raise ValueError(f"band kernel takes a contiguous float32 cost, got {cost.dtype}")
    lib = _build.load_kernels()
    out = torch.empty((b, 3 * h, 3 * w), dtype=torch.float32, device=cost.device)
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    with torch.cuda.device(cost.device):
        err = lib.lst_band_soft_argmin(cost.data_ptr(), out.data_ptr(), b, d, h, w, stream)
    _build.check(err, "band soft-argmin kernel")
    soft_argmin_cuda.launches += 1
    return out


soft_argmin_cuda.launches = 0


@torch.library.custom_op("leastereo::band_soft_argmin", mutates_args=(), device_types="cuda")
def band_soft_argmin(cost: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """``torch.ops.leastereo.band_soft_argmin``: the band kernel on a
    ``(B, D, h, w)`` CUDA cost, taken as a contiguous fp32 copy
    (:func:`soft_argmin_cuda`, which raises on a cost the kernel refuses);
    on the CPU the plain :func:`soft_argmin`. The cost's own dtype is what
    the backward saves (bf16 in training). Graph tools (``torch.export``,
    the FLOP counter) see the op, not the ctypes launch inside it."""
    return soft_argmin_cuda(cost.float().contiguous(), maxdisp)


@band_soft_argmin.register_kernel("cpu")
def _band_soft_argmin_cpu(cost, maxdisp):
    return soft_argmin(cost, maxdisp)


@band_soft_argmin.register_fake
def _band_soft_argmin_fake(cost, maxdisp):
    _check_rank(cost)
    b, _, h, w = cost.shape
    return cost.new_empty((b, 3 * h, 3 * w), dtype=torch.float32)


def _band_setup_context(ctx, inputs, output):
    cost, ctx.maxdisp = inputs
    ctx.save_for_backward(cost)


def _band_backward(ctx, grad):
    """The plain version's gradient, as the JAX ``soft_argmin_fused``
    custom_vjp re-derives it."""
    (cost,) = ctx.saved_tensors
    with torch.enable_grad():
        c = cost.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(soft_argmin(c, ctx.maxdisp), c, grad)
    return g, None


band_soft_argmin.register_autograd(_band_backward, setup_context=_band_setup_context)


@register_flop_formula(torch.ops.leastereo.band_soft_argmin)
def _band_flops(*args, **kwargs) -> int:
    """0: torch's counter counts no elementwise work, so the plain
    ``soft_argmin`` it replaces counts 0 as well."""
    return 0


def soft_argmin_fused(cost: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Drop-in :func:`soft_argmin` with the band kernel's forward:
    ``torch.ops.leastereo.band_soft_argmin``, its backward the plain
    version's on the cost as given."""
    return band_soft_argmin(cost, maxdisp)
