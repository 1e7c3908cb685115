"""Conv + BatchNorm + ReLU (port of ``leastereo_tpu/ops/convbr.py``).

The reference's universal primitive ``ConvBR`` = Conv(bias=False) + BN + ReLU
with Kaiming(fan_out) init (reference ``models/operations_2d.py:31-54``,
``models/operations_3d.py:31-55``). Submodules are named ``conv`` and ``bn``
as in the reference, so reference ``.pth`` checkpoints load by name.

Precision policy (as in the JAX package): parameters and BN statistics stay
float32; the convolution runs in the dtype of its input. In eval mode the BN
affine is folded into the kernel in float32 (``w = scale / sqrt(var + eps)``)
and the bias rides the convolution's epilogue, then the folded kernel is cast
once to the input dtype (``convbr.py:102-107`` of the JAX package).

Layout: a 3-D eval ConvBR follows its input's memory format. Given an NDHWC
(``torch.channels_last_3d``) volume, the folded kernel is cast and laid out
NDHWC in the one copy that casts it, so cuDNN reads and writes the volumes in
place, without transposing either; on the card, with a bias and a ReLU, the
whole ConvBR is one cuDNN call whose epilogue adds the bias and applies the
ReLU (``torch.cudnn_convolution_relu``; a compiler traces it as the custom
op ``torch.ops.leastereo.conv_bias_relu``, which cuDNN's op cannot be traced
as; a shape cuDNN has no fused engine for raises). A bf16 3x3x3 ConvBR of
stride 1 and padding 1 whose (C_in, C_out) the port's own kernel instantiates
(``ops/conv3d.py`` :func:`conv3d_sm90_admits`) runs that kernel instead
(``csrc/conv3d_sm90.cu``; traced as ``torch.ops.leastereo.conv3d_bias_relu_sm90``).
:attr:`ConvBR.eval_routes` counts the 3-D eval convolutions by route:
``ndhwc_sm90`` (eager calls of the kernel's wrapper, not traces),
``ndhwc_fused``, ``ndhwc`` (the convolution, then the ReLU pass, if any: no
ReLU or bias, float64, or the CPU) and ``ncdhw``.

Parallel runs: with ``bn_group`` set (:func:`set_bn_group`), train-mode BN
normalises with the statistics of the global batch over that group
(sync-BN, as flax computes them under GSPMD). Given a
:class:`~leastereo_tpu_torch.parallel.DispPartition`, a depth-3 convolution
takes its neighbours' ±1 planes (``parallel/halo.py``) and convolves with
no depth padding, so a rank's slab of a disparity-sharded volume comes out
as the same planes of the unsharded convolution, in eval and in training
(the exchange has its adjoint); a train-mode BN over such slabs takes its
statistics over the ``disp`` ranks too, through ``bn_group``.
"""

from __future__ import annotations

import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.halo import DispPartition, halo
from ..utils.tracing import compiler_tracing
from .conv3d import conv3d_bias_relu_sm90, conv3d_sm90_admits
from .layout import is_ndhwc

__all__ = ["ConvBR", "conv_bias_relu", "conv_bias_relu_cudnn", "fold_bn", "set_bn_group"]

# The types of the fused route's cuDNN engines; a float64 volume takes the
# unfused NDHWC route.
_FUSED_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def fold_bn(bn: nn.modules.batchnorm._BatchNorm) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN as a per-channel affine ``(w, b)`` in float32."""
    w = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return w, bn.bias - bn.running_mean * w


class ConvBR(nn.Module):
    """Conv(bias=False) + BatchNorm + ReLU over NCHW (``ndim=2``) or NCDHW
    (``ndim=3``), with the reference's ``bn``/``relu`` gates for the output
    heads. ``padding`` is symmetric and numeric, as in torch (the stride-3
    feature ``stem1`` depends on that)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        *,
        ndim: int = 2,
        bn: bool = True,
        relu: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        conv_cls = nn.Conv2d if ndim == 2 else nn.Conv3d
        bn_cls = nn.BatchNorm2d if ndim == 2 else nn.BatchNorm3d
        self.conv = conv_cls(in_channels, out_channels, kernel_size, stride, padding, bias=False)
        nn.init.kaiming_normal_(
            self.conv.weight, mode="fan_out", nonlinearity="relu", generator=generator
        )
        self.bn = bn_cls(out_channels, eps=1e-5, momentum=0.1) if bn else None
        self.relu = relu
        self.bn_group = None  # process group of the train-mode BN statistics

    # Calls of the 3-D eval convolution (:meth:`eval_conv`) by route.
    eval_routes = dict.fromkeys(("ndhwc_sm90", "ndhwc_fused", "ndhwc", "ncdhw"), 0)

    def conv_fn(
        self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, depth_pad: bool = True
    ) -> torch.Tensor:
        """The convolution; without ``depth_pad``, of a slab that already
        carries its depth halo (no padding along depth)."""
        if self.conv.weight.ndim == 4:
            return F.conv2d(x, weight, bias, self.conv.stride, self.conv.padding)
        padding = self.conv.padding if depth_pad else (0, *self.conv.padding[1:])
        return F.conv3d(x, weight, bias, self.conv.stride, padding)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Kernel and bias of the eval-mode conv with BN folded in (float32)."""
        if self.bn is None:
            return self.conv.weight, None
        w, b = fold_bn(self.bn)
        return self.conv.weight * w.view(-1, *([1] * (self.conv.weight.ndim - 1))), b

    def post(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BN (statistics in float32) and the ReLU, after the conv.

        The batch is normalised with its mean and biased variance, and the
        running stats move by ``momentum`` (0.1) towards them: the running
        variance towards the *biased* batch variance, as flax's
        ``nn.BatchNorm`` in the JAX package does. ``nn.BatchNorm*d``, and
        with it the original PyTorch reference, moves it towards the
        unbiased one.

        With ``bn_group`` set the statistics are those of the global batch
        (every rank's rows): fp32, in two passes, each a differentiable
        all_reduce (the sum and the count, then the squared deviations from
        the global mean), so the gradient flows through the other ranks'
        rows as through one batch. Every rank moves its running stats alike."""
        if self.bn is not None:
            bn = self.bn
            xf = x.float()
            dims = [0, *range(2, xf.ndim)]
            if self.bn_group is None:
                with torch.no_grad():
                    var, mean = torch.var_mean(xf, dim=dims, correction=0)
                xf = F.batch_norm(xf, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
            else:
                c = xf.shape[1]
                shape = (1, c, *[1] * (xf.ndim - 2))
                local = torch.cat([xf.sum(dims), xf.new_full((1,), xf.numel() / c)])
                total = dist_fn.all_reduce(local, group=self.bn_group)
                mean = total[:c] / total[c]
                dev = xf - mean.view(shape)
                var = dist_fn.all_reduce(dev.square().sum(dims), group=self.bn_group) / total[c]
                xf = dev * torch.rsqrt(var + bn.eps).view(shape) * bn.weight.view(shape) + bn.bias.view(shape)
            with torch.no_grad():
                bn.running_mean.mul_(1 - bn.momentum).add_(mean.detach(), alpha=bn.momentum)
                bn.running_var.mul_(1 - bn.momentum).add_(var.detach(), alpha=bn.momentum)
                bn.num_batches_tracked += 1
            x = xf.to(x.dtype)
        return torch.relu(x) if self.relu else x

    def forward(self, x: torch.Tensor, part: DispPartition | None = None) -> torch.Tensor:
        """``part``: the depth partition of ``x`` when it is one rank's slab of
        a disparity-sharded volume (its halo is fetched, then :meth:`haloed`)."""
        if part is not None and self.conv.weight.ndim == 5 and self.conv.kernel_size[0] > 1:
            return self.haloed(halo(x, part, self.conv.kernel_size[0] // 2))
        return self._conv_bn(x, True)

    def haloed(self, x: torch.Tensor) -> torch.Tensor:
        """The ConvBR of a slab that already carries its depth halo: the
        convolution with no depth padding, then BN (training) or the folded
        affine (eval), then the ReLU."""
        return self._conv_bn(x, False)

    def _conv_bn(self, x: torch.Tensor, depth_pad: bool) -> torch.Tensor:
        if self.training:
            return self.post(self.conv_fn(x, self.conv.weight.to(x.dtype), None, depth_pad))
        return self.eval_conv(x, self.relu, depth_pad)

    def eval_conv(self, x: torch.Tensor, relu: bool, depth_pad: bool = True) -> torch.Tensor:
        """The eval-mode conv with BN folded in, its bias in the convolution's
        epilogue, then the ReLU if ``relu``. A 3-D convolution keeps the
        layout of ``x`` (module docstring) and counts its route."""
        weight, bias = self.folded()
        bias = None if bias is None else bias.to(x.dtype)
        if not is_ndhwc(x):
            if weight.ndim == 5:
                ConvBR.eval_routes["ncdhw"] += 1
            x = self.conv_fn(x, weight.to(x.dtype), bias, depth_pad)
            return torch.relu(x) if relu else x
        weight = weight.to(x.dtype, memory_format=torch.channels_last_3d)
        padding = list(self.conv.padding if depth_pad else (0, *self.conv.padding[1:]))
        stride = list(self.conv.stride)
        if conv3d_sm90_admits(x, weight, bias, relu, stride, padding):
            if compiler_tracing():
                return torch.ops.leastereo.conv3d_bias_relu_sm90(x, weight, bias)
            ConvBR.eval_routes["ndhwc_sm90"] += 1
            return conv3d_bias_relu_sm90(x, weight, bias)
        if relu and bias is not None and x.is_cuda and x.dtype in _FUSED_DTYPES:
            ConvBR.eval_routes["ndhwc_fused"] += 1
            if compiler_tracing():
                return torch.ops.leastereo.conv_bias_relu(x, weight, bias, stride, padding)
            return conv_bias_relu_cudnn(x, weight, bias, stride, padding)
        ConvBR.eval_routes["ndhwc"] += 1
        # Some CPU convolutions return NCDHW: keep the volume NDHWC.
        x = self.conv_fn(x, weight, bias, depth_pad).contiguous(memory_format=torch.channels_last_3d)
        return torch.relu(x) if relu else x


def conv_bias_relu_cudnn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: list[int],
                         padding: list[int]) -> torch.Tensor:
    """``relu(conv3d(x, weight, bias))`` as one cuDNN call whose epilogue adds
    the bias and applies the ReLU (``torch.cudnn_convolution_relu``), NDHWC
    in and out: the fused route of :meth:`ConvBR.eval_conv`."""
    return torch.cudnn_convolution_relu(x, weight, bias, stride, padding, [1] * len(stride), 1)


@torch.library.custom_op("leastereo::conv_bias_relu", mutates_args=(), device_types="cuda")
def conv_bias_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: list[int],
                   padding: list[int]) -> torch.Tensor:
    """``torch.ops.leastereo.conv_bias_relu``: :func:`conv_bias_relu_cudnn`
    as a traced graph (``torch.export``) holds it, which cuDNN's op cannot
    be traced as; the eager forward calls cuDNN itself."""
    return conv_bias_relu_cudnn(x, weight, bias, stride, padding)


@conv_bias_relu.register_fake
def _conv_bias_relu_fake(x, weight, bias, stride, padding):
    size = [(n + 2 * p - k) // s + 1 for n, p, k, s in zip(x.shape[2:], padding, weight.shape[2:], stride)]
    return torch.empty((x.shape[0], weight.shape[0], *size), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)


def set_bn_group(module: nn.Module, group) -> None:
    """Train-mode BN of every ``ConvBR`` in ``module`` over ``group`` (sync-BN);
    ``None`` restores per-process statistics."""
    for m in module.modules():
        if isinstance(m, ConvBR):
            m.bn_group = group
