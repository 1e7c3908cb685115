"""Fused matching head: the ``last_3`` 3x3x3 conv (C -> 1) + 3x upsample +
softmin + soft-argmin in one kernel.

Port of ``leastereo_tpu/ops/pallas_head.py``. The CUDA kernel
(``csrc/soft_argmin_heads.cu``, ``lst_head_soft_argmin``) replaces the Pallas
``_head_kernel`` (``pallas_head.py:96-236``). Each block computes its own
``(D, TH+2, TW+2)`` cost tile from the pre-head volume, accumulating the
``27 * C`` taps in fp32 even for a bf16 volume (the property the TPU kernel's
parity record credits: rounding the cost to bf16 moves the disparity by up
to ~1.3 px), edge-replicates the tile after the conv, and runs the band
kernel's upsample + softmin stage on it. The ``(B, D, h, w)`` cost never
reaches device memory.

On the H100 this first version runs the conv on CUDA cores in fp32 (5.9
GFLOP per KITTI frame) with one ~200 KB block per SM, so the latency of
staging the volume channel by channel and the FMA throughput bound it, not
its 218 MB bf16 read; the TPU's band-matrix formulation and halo DMAs are
layout for the MXU and are not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .softargmin import soft_argmin

__all__ = [
    "fused_head_gate_reason",
    "conv_soft_argmin_reference",
    "conv_soft_argmin_cuda",
    "conv_soft_argmin_fused",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_head_gate_reason(channels: int, d: int, maxdisp: int, dtype: torch.dtype) -> str | None:
    """``None`` when the fused head kernel takes a ``(B, channels, d, h, w)``
    volume of ``dtype``; otherwise a reason to run the ``last_3`` conv and the
    band kernel instead. Any ``h``, ``w`` and batch are taken."""
    if maxdisp != 3 * d:
        return f"maxdisp {maxdisp} != 3 * D ({d})"
    if dtype not in _DTYPES:
        return f"volume dtype {dtype} (kernel takes float32 or bfloat16)"
    smem = _build.head_smem_bytes(channels, d)
    if smem > _build.SMEM_LIMIT:
        return f"D={d}, C={channels} needs {smem} B of shared memory > {_build.SMEM_LIMIT}"
    return None


def conv_soft_argmin_reference(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Plain version: fp32 (float64 for float64 input) ``F.conv3d`` with zero
    padding 1, then :func:`soft_argmin`. ``vol`` is NCDHW ``(B, C, D, h, w)``,
    ``kernel`` OIDHW ``(1, C, 3, 3, 3)``; returns ``(B, 3h, 3w)``."""
    dt = torch.float64 if vol.dtype == torch.float64 else torch.float32
    cost = F.conv3d(vol.to(dt), kernel.to(dt), padding=1)[:, 0]
    return soft_argmin(cost, maxdisp)


def conv_soft_argmin_cuda(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Fused head on a ``(B, C, D, h, w)`` volume with a ``(1, C, 3, 3, 3)``
    kernel -> ``(B, 3h, 3w)`` fp32.

    A CUDA volume (float32 or bfloat16, contiguous) runs the kernel; the
    kernel weights are taken in fp32. A CPU volume takes
    :func:`conv_soft_argmin_reference`. ``conv_soft_argmin_cuda.launches``
    counts the kernel launches.
    """
    if vol.ndim != 5 or tuple(kernel.shape) != (1, vol.shape[1], 3, 3, 3):
        raise ValueError(f"expected (B, C, D, h, w) and (1, C, 3, 3, 3), got {tuple(vol.shape)}, {tuple(kernel.shape)}")
    if vol.device.type == "cpu":
        return conv_soft_argmin_reference(vol, kernel, maxdisp)
    if vol.device.type != "cuda" or kernel.device != vol.device:
        raise ValueError(f"volume on {vol.device} and kernel on {kernel.device}: both must be on one CUDA device")
    b, c, d, h, w = vol.shape
    reason = fused_head_gate_reason(c, d, maxdisp, vol.dtype)
    if reason is not None:
        raise ValueError(f"fused head refuses this volume: {reason}")
    if not vol.is_contiguous():
        raise ValueError("fused head takes a contiguous volume")
    lib = _build.load_kernels()
    k32 = kernel.to(torch.float32).contiguous()
    out = torch.empty((b, 3 * h, 3 * w), dtype=torch.float32, device=vol.device)
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    with torch.cuda.device(vol.device):
        err = lib.lst_head_soft_argmin(
            vol.data_ptr(), _DTYPES[vol.dtype], k32.data_ptr(), out.data_ptr(), b, c, d, h, w, stream
        )
    _build.check(err, "fused head kernel")
    conv_soft_argmin_cuda.launches += 1
    return out


conv_soft_argmin_cuda.launches = 0


class _ConvSoftArgminFn(torch.autograd.Function):
    """Kernel forward; backward re-derived through the plain version, as the
    JAX ``conv_soft_argmin_fused`` custom_vjp does."""

    @staticmethod
    def forward(ctx, vol, kernel, maxdisp):
        ctx.save_for_backward(vol, kernel)
        ctx.maxdisp = maxdisp
        return conv_soft_argmin_cuda(vol, kernel, maxdisp)

    @staticmethod
    def backward(ctx, grad):
        vol, kernel = ctx.saved_tensors
        with torch.enable_grad():
            v = vol.detach().requires_grad_(True)
            k = kernel.detach().requires_grad_(True)
            out = conv_soft_argmin_reference(v, k, ctx.maxdisp)
            gv, gk = torch.autograd.grad(out, (v, k), grad)
        return gv, gk, None


def conv_soft_argmin_fused(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Drop-in fused head: kernel forward, plain-version backward."""
    return _ConvSoftArgminFn.apply(vol, kernel, maxdisp)
