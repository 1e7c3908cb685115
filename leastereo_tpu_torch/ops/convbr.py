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
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ConvBR", "fold_bn"]


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

    def conv_fn(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None):
        conv = F.conv2d if self.conv.weight.ndim == 4 else F.conv3d
        return conv(x, weight, bias, self.conv.stride, self.conv.padding)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Kernel and bias of the eval-mode conv with BN folded in (float32)."""
        if self.bn is None:
            return self.conv.weight, None
        w, b = fold_bn(self.bn)
        return self.conv.weight * w.view(-1, *([1] * (self.conv.weight.ndim - 1))), b

    def post(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BN (statistics in float32) and the ReLU, after the conv."""
        if self.bn is not None:
            x = self.bn(x.float()).to(x.dtype)
        return torch.relu(x) if self.relu else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self.post(self.conv_fn(x, self.conv.weight.to(x.dtype), None))
        weight, bias = self.folded()
        x = self.conv_fn(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))
        return torch.relu(x) if self.relu else x
