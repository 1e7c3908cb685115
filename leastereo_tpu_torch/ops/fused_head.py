"""Fused matching head: the ``last_3`` 3x3x3 conv (C -> 1) + 3x upsample +
softmin + soft-argmin in one kernel.

Port of ``leastereo_tpu/ops/pallas_head.py``. ``csrc/fused_head_sm90.cu``
replaces the Pallas ``_head_kernel`` (``pallas_head.py:96-236``) for every
bf16 and fp32 volume, any channel count: each block computes its ``(D, TH+2,
TW+2)`` cost tile from the pre-head volume, accumulating the ``27 * C`` taps in
fp32 even for a bf16 volume (the property the TPU kernel's parity record
credits: rounding the cost to bf16 moves the disparity by up to ~1.3 px),
edge-replicates the tile after the conv, and runs the band kernel's upsample +
softmin stage on it. The ``(B, D, h, w)`` cost never reaches device memory.
One body stages the volume plane by plane into an mbarrier ring (C padded to
a multiple of 16 up to 64, 32-channel groups above), contracts the channels
on tensor cores (``mma.sync``) and sums the 27 taps in fp32; TMA stages it,
so the rows must start on 16-byte boundaries. Four routes, each a wrapper
with its own launch count:

- :func:`conv_soft_argmin_sm90`, the main path's: a bf16 volume read in
  place; each fp32 weight split into three bf16 parts whose sum is exact (one
  part when the weights are bf16).
- :func:`conv_soft_argmin_sm90_f32`: an fp32 volume read in place, 3xTF32
  (each voxel and weight split into two tf32 parts and three products kept),
  so the conv is fp32-accurate whatever the TF32 flags of cuDNN and cuBLAS
  say.
- :func:`conv_soft_argmin_sm90_repitch` and
  :func:`conv_soft_argmin_sm90_f32_repitch`: the same kernels for volumes TMA
  cannot read in place (rows not whole 16-byte lines: bf16 ``w % 8 != 0``,
  fp32 ``w % 4 != 0``; or a base not 16-byte aligned), first copied into an
  aligned buffer whose rows are padded to whole lines.

:func:`fused_head_route` picks the route from the shape and the address,
before launch; :func:`conv_soft_argmin_cuda` takes it. The model reaches it
through the custom op ``torch.ops.leastereo.conv_soft_argmin``
(:func:`conv_soft_argmin`), registered when the package is imported, with a
fake implementation for tracing and the plain version's backward. A volume
every route refuses (a ``D`` too deep for the cost tile, or ``maxdisp !=
3 * D``) keeps the model's unfused route: cuDNN ``last_3``, then the band
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .softargmin import soft_argmin

__all__ = [
    "ROUTES",
    "ROUTE_WRAPPERS",
    "fused_head_sm90_gate_reason",
    "fused_head_route",
    "repitched",
    "conv_soft_argmin_reference",
    "conv_soft_argmin_sm90",
    "conv_soft_argmin_sm90_f32",
    "conv_soft_argmin_sm90_repitch",
    "conv_soft_argmin_sm90_f32_repitch",
    "conv_soft_argmin_cuda",
    "conv_soft_argmin",
    "conv_soft_argmin_fused",
]

# The fused head's routes: (volume dtype, read in place or copied to padded rows first).
ROUTES = {
    "sm90": (torch.bfloat16, True),
    "sm90_f32": (torch.float32, True),
    "sm90_repitch": (torch.bfloat16, False),
    "sm90_f32_repitch": (torch.float32, False),
}
_TMA_LINE = 16  # bytes: TMA needs 16-byte row strides and a 16-byte aligned base


def fused_head_sm90_gate_reason(channels: int, d: int, maxdisp: int, dtype: torch.dtype) -> str | None:
    """``None`` when an sm90 fused head takes a contiguous ``(B, channels, d,
    h, w)`` volume of ``dtype`` (any ``channels``, ``h``, ``w`` and batch);
    otherwise the reason it refuses."""
    if maxdisp != 3 * d:
        return f"maxdisp {maxdisp} != 3 * D ({d})"
    if dtype not in (torch.bfloat16, torch.float32):
        return f"volume dtype {dtype} (the sm90 kernels take bfloat16 or float32)"
    if channels < 1:
        return f"C={channels}"
    if dtype == torch.bfloat16:
        smem = _build.head_sm90_smem_bytes(channels, d)
    else:
        smem = _build.head_sm90_f32_smem_bytes(channels, d)
    if smem > _build.SMEM_LIMIT:
        return f"D={d}, C={channels} needs {smem} B of shared memory > {_build.SMEM_LIMIT}"
    return None


def _tma_rows(w: int, dtype: torch.dtype) -> bool:
    return w * dtype.itemsize % _TMA_LINE == 0


def fused_head_route(channels: int, d: int, w: int, maxdisp: int, dtype: torch.dtype,
                     aligned: bool = True) -> str | None:
    """Which fused head route takes a contiguous ``(B, channels, d, h, w)``
    volume of ``dtype`` whose base is 16-byte aligned (``aligned``) or not:
    ``"sm90"`` (bf16) or ``"sm90_f32"`` (fp32) when TMA can read it in place
    (rows of whole 16-byte lines, an aligned base), else ``"sm90_repitch"``
    or ``"sm90_f32_repitch"``; ``None`` when the gate refuses it."""
    if fused_head_sm90_gate_reason(channels, d, maxdisp, dtype) is not None:
        return None
    route = "sm90" if dtype == torch.bfloat16 else "sm90_f32"
    return route if aligned and _tma_rows(w, dtype) else route + "_repitch"


def repitched(vol: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(copy, pitch)``: a copy of the contiguous ``(..., w)`` volume whose
    rows lie ``pitch`` elements apart, the fewest ``>= w`` that fill whole
    16-byte lines; what TMA reads when the volume's rows are not whole lines
    or its base is unaligned. The allocator aligns the copy's base; the
    columns past ``w`` are left unwritten (the tensor map's extent is ``w``).
    The copy moves the widest integer words that divide a row and the
    volume's address (bf16 w = 412: 8 bytes), not elements."""
    w, es = vol.shape[-1], vol.element_size()
    pitch = -(-w * es // _TMA_LINE) * _TMA_LINE // es
    out = vol.new_empty((*vol.shape[:-1], pitch))
    word = next(t for t in (torch.int64, torch.int32, torch.int16, torch.uint8)
                if w * es % t.itemsize == 0 and vol.data_ptr() % t.itemsize == 0)
    out.view(word)[..., : w * es // word.itemsize].copy_(vol.view(word))
    return out, pitch


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


def _sm90(route: str, vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Gate, check and launch ``route`` on a CUDA volume, counting the launch
    on its wrapper's ``launches``; a CPU volume takes the plain version."""
    _check_args(vol, kernel)
    if vol.device.type == "cpu":
        return conv_soft_argmin_reference(vol, kernel, maxdisp)
    b, c, d, h, w = vol.shape
    dtype, in_place = ROUTES[route]
    what = f"fused head route {route}"
    if vol.dtype != dtype:
        raise ValueError(f"{what} takes a {dtype} volume, got {vol.dtype}")
    reason = fused_head_sm90_gate_reason(c, d, maxdisp, vol.dtype)
    if reason is not None:
        raise ValueError(f"{what} refuses this volume: {reason}")
    if not vol.is_contiguous():
        raise ValueError(f"{what} takes a contiguous volume")
    if in_place:
        if vol.data_ptr() % _TMA_LINE or not _tma_rows(w, dtype):
            raise ValueError(f"{what} takes a 16-byte aligned volume whose rows are whole 16-byte lines (w={w})")
        src, pitch = vol, w
    else:
        src, pitch = repitched(vol)
    entry = _build.HEAD_SM90_ENTRIES[dtype == torch.float32]
    out = _launch(vol, kernel, f"{what} kernel", lambda lib, k32, out, stream: getattr(lib, entry)(
        src.data_ptr(), k32.data_ptr(), out.data_ptr(), b, c, d, h, w, pitch, stream))
    ROUTE_WRAPPERS[route].launches += 1
    return out


def conv_soft_argmin_sm90(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Route ``"sm90"`` (``lst_head_sm90_soft_argmin``, read in place) on a
    ``(B, C, D, h, w)`` bfloat16 contiguous, 16-byte aligned CUDA volume with
    ``w % 8 == 0`` that :func:`fused_head_sm90_gate_reason` admits, with a
    ``(1, C, 3, 3, 3)`` kernel (taken in fp32) -> ``(B, 3h, 3w)`` fp32. A CPU
    volume takes :func:`conv_soft_argmin_reference`. ``.launches`` counts the
    launches."""
    return _sm90("sm90", vol, kernel, maxdisp)


def conv_soft_argmin_sm90_f32(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Route ``"sm90_f32"`` (``lst_head_sm90_f32_soft_argmin``, read in place,
    3xTF32 contraction) on a float32 contiguous, 16-byte aligned CUDA volume
    with ``w % 4 == 0``; otherwise as :func:`conv_soft_argmin_sm90`."""
    return _sm90("sm90_f32", vol, kernel, maxdisp)


def conv_soft_argmin_sm90_repitch(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Route ``"sm90_repitch"``: any bfloat16 contiguous CUDA volume the gate
    admits, copied into an aligned buffer with rows padded to whole 16-byte
    lines, then ``lst_head_sm90_soft_argmin`` on it; otherwise as
    :func:`conv_soft_argmin_sm90`."""
    return _sm90("sm90_repitch", vol, kernel, maxdisp)


def conv_soft_argmin_sm90_f32_repitch(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Route ``"sm90_f32_repitch"``: the same for any float32 contiguous CUDA
    volume, then ``lst_head_sm90_f32_soft_argmin`` (3xTF32) on the copy."""
    return _sm90("sm90_f32_repitch", vol, kernel, maxdisp)


# Each route's wrapper, whose ``launches`` counts its launches.
ROUTE_WRAPPERS = {"sm90": conv_soft_argmin_sm90, "sm90_f32": conv_soft_argmin_sm90_f32,
                  "sm90_repitch": conv_soft_argmin_sm90_repitch,
                  "sm90_f32_repitch": conv_soft_argmin_sm90_f32_repitch}
for _fn in ROUTE_WRAPPERS.values():
    _fn.launches = 0


def conv_soft_argmin_cuda(vol: torch.Tensor, kernel: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Fused head on a ``(B, C, D, h, w)`` volume with a ``(1, C, 3, 3, 3)``
    kernel -> ``(B, 3h, 3w)`` fp32.

    A contiguous CUDA volume the gate admits runs the route
    :func:`fused_head_route` gives it; any other CUDA volume raises. A CPU
    volume takes :func:`conv_soft_argmin_reference`. The route reads the
    volume's address, so it is taken here, on real tensors, inside the op.
    """
    _check_args(vol, kernel)
    if vol.device.type == "cpu":
        return conv_soft_argmin_reference(vol, kernel, maxdisp)
    _, c, d, _, w = vol.shape
    route = fused_head_route(c, d, w, maxdisp, vol.dtype, aligned=vol.data_ptr() % _TMA_LINE == 0)
    if route is None:
        raise ValueError(f"fused head refuses this volume: {fused_head_sm90_gate_reason(c, d, maxdisp, vol.dtype)}")
    return ROUTE_WRAPPERS[route](vol, kernel, maxdisp)


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
