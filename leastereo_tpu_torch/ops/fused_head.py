"""Fused matching head: the ``last_3`` 3x3x3 conv (C -> 1) + 3x upsample +
softmin + soft-argmin in one kernel.

Port of ``leastereo_tpu/ops/pallas_head.py``. CUDA kernels replace the
Pallas ``_head_kernel`` (``pallas_head.py:96-236``); each computes each
block's ``(D, TH+2, TW+2)`` cost tile from the pre-head volume, accumulating
the ``27 * C`` taps in fp32 even for a bf16 volume (the property the TPU
kernel's parity record credits: rounding the cost to bf16 moves the
disparity by up to ~1.3 px), edge-replicates the tile after the conv, and
runs the band kernel's upsample + softmin stage on it. The ``(B, D, h, w)``
cost never reaches device memory.

- ``csrc/fused_head_sm90.cu``, one body for two volume types: volumes staged
  plane by plane with TMA into an mbarrier ring, the channel contraction on
  tensor cores (``mma.sync``), the 27-tap sum in fp32.
  - :func:`conv_soft_argmin_sm90`, the main path's, bf16 volumes: each fp32
    weight split into three bf16 parts whose sum is exact (one part when the
    weights are bf16).
  - :func:`conv_soft_argmin_sm90_f32`, fp32 volumes: 3xTF32, each voxel and
    weight split into two tf32 parts and three products kept, so the conv
    is fp32-accurate whatever the TF32 flags of cuDNN and cuBLAS say.
- ``csrc/soft_argmin_heads.cu`` (:func:`conv_soft_argmin_simt`), the first
  design: the conv in fp32 on CUDA cores, one input channel staged at a time.
  It serves the bf16 and fp32 shapes both sm90 gates refuse.

:func:`conv_soft_argmin_cuda` routes between them before launch. The model
reaches it through the custom op ``torch.ops.leastereo.conv_soft_argmin``
(:func:`conv_soft_argmin`), registered when the package is imported, with a
fake implementation for tracing and the plain version's backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .softargmin import soft_argmin

__all__ = [
    "fused_head_gate_reason",
    "fused_head_sm90_gate_reason",
    "fused_head_route",
    "conv_soft_argmin_reference",
    "conv_soft_argmin_simt",
    "conv_soft_argmin_sm90",
    "conv_soft_argmin_sm90_f32",
    "conv_soft_argmin_cuda",
    "conv_soft_argmin",
    "conv_soft_argmin_fused",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_head_gate_reason(channels: int, d: int, maxdisp: int, dtype: torch.dtype) -> str | None:
    """``None`` when the first fused head kernel (``head_kernel``) takes a
    ``(B, channels, d, h, w)`` volume of ``dtype``; otherwise the reason it
    refuses. Any ``h``, ``w`` and batch are taken."""
    if maxdisp != 3 * d:
        return f"maxdisp {maxdisp} != 3 * D ({d})"
    if dtype not in _DTYPES:
        return f"volume dtype {dtype} (kernel takes float32 or bfloat16)"
    smem = _build.head_smem_bytes(channels, d)
    if smem > _build.SMEM_LIMIT:
        return f"D={d}, C={channels} needs {smem} B of shared memory > {_build.SMEM_LIMIT}"
    return None


def fused_head_sm90_gate_reason(channels: int, d: int, w: int, maxdisp: int, dtype: torch.dtype) -> str | None:
    """``None`` when an sm90 fused head takes a contiguous ``(B, channels, d,
    h, w)`` volume of ``dtype`` (bfloat16: :func:`conv_soft_argmin_sm90`;
    float32: :func:`conv_soft_argmin_sm90_f32`); otherwise the reason it
    refuses. Any ``h`` and batch are taken."""
    if maxdisp != 3 * d:
        return f"maxdisp {maxdisp} != 3 * D ({d})"
    if dtype not in (torch.bfloat16, torch.float32):
        return f"volume dtype {dtype} (the sm90 kernels take bfloat16 or float32)"
    if channels % 16 or not 16 <= channels <= 64:
        return f"C={channels} (the sm90 kernels take 16, 32, 48 or 64 channels)"
    per_row = 8 if dtype == torch.bfloat16 else 4
    if w % per_row:
        return f"w={w} is not a multiple of {per_row} (TMA needs 16-byte row strides)"
    if dtype == torch.bfloat16:
        smem = _build.head_sm90_smem_bytes(channels, d)
    else:
        smem = _build.head_sm90_f32_smem_bytes(channels, d)
    if smem > _build.SMEM_LIMIT:
        return f"D={d}, C={channels} needs {smem} B of shared memory > {_build.SMEM_LIMIT}"
    return None


def fused_head_route(channels: int, d: int, w: int, maxdisp: int, dtype: torch.dtype) -> str | None:
    """Which fused head kernel takes a contiguous ``(B, channels, d, h, w)``
    volume of ``dtype``: ``"sm90"`` (bf16) or ``"sm90_f32"`` (fp32), then
    ``"simt"`` (the first design), or ``None`` when all refuse it."""
    if fused_head_sm90_gate_reason(channels, d, w, maxdisp, dtype) is None:
        return "sm90" if dtype == torch.bfloat16 else "sm90_f32"
    if fused_head_gate_reason(channels, d, maxdisp, dtype) is None:
        return "simt"
    return None


def conv_soft_argmin_reference(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Plain version: fp32 (float64 for float64 input) ``F.conv3d`` with zero
    padding 1, then :func:`soft_argmin`. ``vol`` is NCDHW ``(B, C, D, h, w)``,
    ``kernel`` OIDHW ``(1, C, 3, 3, 3)``; returns ``(B, 3h, 3w)``."""
    dt = torch.float64 if vol.dtype == torch.float64 else torch.float32
    cost = F.conv3d(vol.to(dt), kernel.to(dt), padding=1)[:, 0]
    return soft_argmin(cost, maxdisp)


def _check_args(vol: torch.Tensor, kernel: torch.Tensor) -> None:
    if vol.ndim != 5 or tuple(kernel.shape) != (1, vol.shape[1], 3, 3, 3):
        raise ValueError(f"expected (B, C, D, h, w) and (1, C, 3, 3, 3), got {tuple(vol.shape)}, {tuple(kernel.shape)}")
    if vol.device.type != "cpu" and (vol.device.type != "cuda" or kernel.device != vol.device):
        raise ValueError(f"volume on {vol.device} and kernel on {kernel.device}: both must be on one CUDA device")


def _launch(vol: torch.Tensor, kernel: torch.Tensor, what: str, call) -> torch.Tensor:
    """Allocate the ``(B, 3h, 3w)`` output, run ``call(lib, k32, out, stream)``
    (a C launch returning an error code) on the volume's device, and raise on
    a non-zero code."""
    b, _, _, h, w = vol.shape
    lib = _build.load_kernels()
    k32 = kernel.to(torch.float32).contiguous()
    out = torch.empty((b, 3 * h, 3 * w), dtype=torch.float32, device=vol.device)
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    with torch.cuda.device(vol.device):
        err = call(lib, k32, out, stream)
    _build.check(err, what)
    return out


def conv_soft_argmin_simt(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """The first fused head kernel (``lst_head_soft_argmin``) on a ``(B, C,
    D, h, w)`` float32 or bfloat16 contiguous CUDA volume with a ``(1, C, 3,
    3, 3)`` kernel (taken in fp32) -> ``(B, 3h, 3w)`` fp32. A CPU volume takes
    :func:`conv_soft_argmin_reference`. ``.launches`` counts the launches."""
    _check_args(vol, kernel)
    if vol.device.type == "cpu":
        return conv_soft_argmin_reference(vol, kernel, maxdisp)
    b, c, d, h, w = vol.shape
    reason = fused_head_gate_reason(c, d, maxdisp, vol.dtype)
    if reason is not None:
        raise ValueError(f"fused head refuses this volume: {reason}")
    if not vol.is_contiguous():
        raise ValueError("fused head takes a contiguous volume")
    out = _launch(vol, kernel, "fused head kernel", lambda lib, k32, out, stream: lib.lst_head_soft_argmin(
        vol.data_ptr(), _DTYPES[vol.dtype], k32.data_ptr(), out.data_ptr(), b, c, d, h, w, stream))
    conv_soft_argmin_simt.launches += 1
    return out


conv_soft_argmin_simt.launches = 0


def _sm90(wrapper, vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int, dtype: torch.dtype, what: str, entry: str):
    """Gate, check and launch one of the sm90 heads (``lib.<entry>``) on a
    CUDA volume of ``dtype``, counting the launch on ``wrapper.launches``; a
    CPU volume takes the plain version."""
    _check_args(vol, kernel)
    if vol.device.type == "cpu":
        return conv_soft_argmin_reference(vol, kernel, maxdisp)
    b, c, d, h, w = vol.shape
    if vol.dtype != dtype:
        raise ValueError(f"{what} takes a {dtype} volume, got {vol.dtype}")
    reason = fused_head_sm90_gate_reason(c, d, w, maxdisp, vol.dtype)
    if reason is not None:
        raise ValueError(f"{what} refuses this volume: {reason}")
    if not vol.is_contiguous() or vol.data_ptr() % 16:
        raise ValueError(f"{what} takes a contiguous, 16-byte aligned volume")
    out = _launch(vol, kernel, f"{what} kernel", lambda lib, k32, out, stream: getattr(lib, entry)(
        vol.data_ptr(), k32.data_ptr(), out.data_ptr(), b, c, d, h, w, stream))
    wrapper.launches += 1
    return out


def conv_soft_argmin_sm90(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """The sm90 fused head (``lst_head_sm90_soft_argmin``) on a ``(B, C, D, h,
    w)`` bfloat16 contiguous, 16-byte aligned CUDA volume that
    :func:`fused_head_sm90_gate_reason` admits, with a ``(1, C, 3, 3, 3)``
    kernel (taken in fp32) -> ``(B, 3h, 3w)`` fp32. A CPU volume takes
    :func:`conv_soft_argmin_reference`. ``.launches`` counts the launches."""
    return _sm90(conv_soft_argmin_sm90, vol, kernel, maxdisp, torch.bfloat16, "sm90 fused head",
                 "lst_head_sm90_soft_argmin")


conv_soft_argmin_sm90.launches = 0


def conv_soft_argmin_sm90_f32(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """The fp32 sm90 fused head (``lst_head_sm90_f32_soft_argmin``, 3xTF32
    contraction) on a ``(B, C, D, h, w)`` float32 contiguous, 16-byte aligned
    CUDA volume that :func:`fused_head_sm90_gate_reason` admits, with a
    ``(1, C, 3, 3, 3)`` kernel (taken in fp32) -> ``(B, 3h, 3w)`` fp32. A CPU
    volume takes :func:`conv_soft_argmin_reference`. ``.launches`` counts the
    launches, apart from the bf16 kernel's."""
    return _sm90(conv_soft_argmin_sm90_f32, vol, kernel, maxdisp, torch.float32, "fp32 sm90 fused head",
                 "lst_head_sm90_f32_soft_argmin")


conv_soft_argmin_sm90_f32.launches = 0

_SM90 = {"sm90": conv_soft_argmin_sm90, "sm90_f32": conv_soft_argmin_sm90_f32}


def conv_soft_argmin_cuda(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Fused head on a ``(B, C, D, h, w)`` volume with a ``(1, C, 3, 3, 3)``
    kernel -> ``(B, 3h, 3w)`` fp32.

    A CUDA volume an sm90 gate admits (bf16 or fp32, contiguous, 16-byte
    aligned) runs :func:`conv_soft_argmin_sm90` or
    :func:`conv_soft_argmin_sm90_f32`; any other CUDA volume runs
    :func:`conv_soft_argmin_simt`, which raises on what it refuses. A CPU
    volume takes :func:`conv_soft_argmin_reference`. The route reads the
    volume's address, so it is taken here, on real tensors, inside the op.
    """
    _check_args(vol, kernel)
    if vol.device.type == "cpu":
        return conv_soft_argmin_reference(vol, kernel, maxdisp)
    _, c, d, _, w = vol.shape
    aligned = vol.is_contiguous() and vol.data_ptr() % 16 == 0
    route = fused_head_route(c, d, w, maxdisp, vol.dtype) if aligned else None
    if route in _SM90:
        return _SM90[route](vol, kernel, maxdisp)
    return conv_soft_argmin_simt(vol, kernel, maxdisp)


@torch.library.custom_op("leastereo::conv_soft_argmin", mutates_args=(), device_types="cuda")
def conv_soft_argmin(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """``torch.ops.leastereo.conv_soft_argmin``: the fused head
    (:func:`conv_soft_argmin_cuda`) on a CUDA volume; on the CPU the plain
    :func:`conv_soft_argmin_reference`. Graph tools (``torch.export``, the
    FLOP counter) see the op, not the ctypes launch inside it."""
    return conv_soft_argmin_cuda(vol, kernel, maxdisp)


@conv_soft_argmin.register_kernel("cpu")
def _conv_soft_argmin_cpu(vol, kernel, maxdisp):
    _check_args(vol, kernel)
    return conv_soft_argmin_reference(vol, kernel, maxdisp)


@conv_soft_argmin.register_fake
def _conv_soft_argmin_fake(vol, kernel, maxdisp):
    _check_args(vol, kernel)
    b, _, _, h, w = vol.shape
    return vol.new_empty((b, 3 * h, 3 * w), dtype=torch.float32)


def _head_setup_context(ctx, inputs, output):
    vol, kernel, ctx.maxdisp = inputs
    ctx.save_for_backward(vol, kernel)


def _head_backward(ctx, grad):
    """The plain version's gradients, as the JAX ``conv_soft_argmin_fused``
    custom_vjp re-derives them."""
    vol, kernel = ctx.saved_tensors
    with torch.enable_grad():
        v = vol.detach().requires_grad_(True)
        k = kernel.detach().requires_grad_(True)
        out = conv_soft_argmin_reference(v, k, ctx.maxdisp)
        gv, gk = torch.autograd.grad(out, (v, k), grad)
    return gv, gk, None


conv_soft_argmin.register_autograd(_head_backward, setup_context=_head_setup_context)


@register_flop_formula(torch.ops.leastereo.conv_soft_argmin)
def _head_flops(vol_shape, kernel_shape, *args, **kwargs) -> int:
    """``2 * 27 * C * B * D * h * w``: what ``aten.convolution`` counts for
    the ``last_3`` conv the op contains (the softmin stage, elementwise,
    counts 0, as the plain ``soft_argmin`` does), so a model counts the same
    FLOPs with the head fused or not."""
    b, c, d, h, w = vol_shape
    return 2 * 27 * c * b * d * h * w


def conv_soft_argmin_fused(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Drop-in fused head: ``torch.ops.leastereo.conv_soft_argmin``, kernel
    forward, plain-version backward."""
    return conv_soft_argmin(vol, kernel, maxdisp)
