"""The eval matching net's 3x3x3 convolutions on the card's tensor cores.

``relu(conv3d(x, w) + b)`` of an NDHWC (``channels_last_3d``) bf16 volume,
stride 1, padding 1, with fp32 sums and one bf16 rounding at the end, as
the hand-written kernel ``csrc/conv3d_sm90.cu`` computes it (a TMA-fed ring
of haloed input planes, the 27 taps on ``mma.sync`` straight from the staged
planes, bias and ReLU in the epilogue). :func:`conv3d_sm90_admits` is the
gate :meth:`~leastereo_tpu_torch.ops.convbr.ConvBR.eval_conv` routes by: it
reads only what the call shows (device, type, layout, kernel, stride,
padding, bias, ReLU, channels), and admits the (C_in, C_out) classes the
kernel instantiates (``_build.CONV3D_SM90_TILES``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import _build
from .layout import is_ndhwc

__all__ = ["conv3d_sm90_admits", "conv3d_bias_relu_sm90", "conv3d_bias_relu_plain", "conv3d_bias_relu_sm90_op"]


def conv3d_sm90_admits(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, relu: bool,
                       stride, padding) -> bool:
    """Whether :func:`conv3d_bias_relu_sm90` takes this convolution: a CUDA
    NDHWC bf16 volume, a 3x3x3 kernel at stride 1 and padding 1 in every
    dimension, a bias and a ReLU, and an instantiated (C_in, C_out) class."""
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16 and is_ndhwc(x) and bias is not None and relu
            and tuple(weight.shape[2:]) == (3, 3, 3) and tuple(stride) == (1, 1, 1)
            and tuple(padding) == (1, 1, 1) and (x.shape[1], weight.shape[0]) in _build.CONV3D_SM90_TILES)


def conv3d_bias_relu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.conv3d`` plus the bias in float32, the ReLU,
    one rounding to the volume's type, NDHWC out."""
    y = torch.relu(F.conv3d(x.float(), weight.float(), bias.float(), padding=1))
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last_3d)


def conv3d_bias_relu_sm90(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel ``lst_conv3d_sm90``: ``relu(conv3d(x, weight, padding=1) + bias)``
    of an NDHWC bf16 CUDA volume ``(N, C_in, D, H, W)`` with a bf16
    ``(C_out, C_in, 3, 3, 3)`` kernel laid out ``channels_last_3d`` and a bf16
    bias, NDHWC out; on the CPU, :func:`conv3d_bias_relu_plain`. Raises on
    anything else the kernel does not take. ``.launches`` counts the launches."""
    if x.device.type == "cpu":
        return conv3d_bias_relu_plain(x, weight, bias)
    cin, cout = x.shape[1], weight.shape[0]
    if not (x.device.type == "cuda" and x.dtype == weight.dtype == bias.dtype == torch.bfloat16 and is_ndhwc(x)
            and (cin, cout) in _build.CONV3D_SM90_TILES and tuple(weight.shape) == (cout, cin, 3, 3, 3)
            and weight.is_contiguous(memory_format=torch.channels_last_3d) and bias.shape == (cout,)
            and bias.is_contiguous() and weight.device == bias.device == x.device and x.data_ptr() % 16 == 0):
        raise ValueError(f"the sm90 3x3x3 convolution takes a 16-byte aligned NDHWC bf16 CUDA volume of a class in "
                         f"{sorted(_build.CONV3D_SM90_TILES)} with its channels_last_3d bf16 kernel and bias, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()} on {x.device}, kernel {weight.dtype} "
                         f"{tuple(weight.shape)} strides {weight.stride()}, bias {bias.dtype} {tuple(bias.shape)}")
    n, _, d, h, w = x.shape
    out = torch.empty((n, cout, d, h, w), dtype=x.dtype, device=x.device, memory_format=torch.channels_last_3d)
    lib = _build.load_kernels()
    # The launch goes to the current device: make it x's where it is not
    # already (the context costs a few microseconds of each of a frame's 73 calls).
    with contextlib.nullcontext() if x.device.index == torch.cuda.current_device() else torch.cuda.device(x.device):
        err = lib.lst_conv3d_sm90(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                  n, cin, cout, d, h, w, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sm90 3x3x3 convolution kernel")
    conv3d_bias_relu_sm90.launches += 1
    return out


conv3d_bias_relu_sm90.launches = 0


@torch.library.custom_op("leastereo::conv3d_bias_relu_sm90", mutates_args=(), device_types="cuda")
def conv3d_bias_relu_sm90_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``torch.ops.leastereo.conv3d_bias_relu_sm90``: :func:`conv3d_bias_relu_sm90`
    as a traced graph (``torch.export``) holds it; the eager forward calls
    the wrapper itself."""
    return conv3d_bias_relu_sm90(x, weight, bias)


@conv3d_bias_relu_sm90_op.register_fake
def _conv3d_bias_relu_sm90_fake(x, weight, bias):
    return torch.empty((x.shape[0], weight.shape[0], *x.shape[2:]), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)
