"""Plain PyTorch LEAStereo: the yardstick every cell is held to.

Written from the published network (LEAStereo, Cheng et al., NeurIPS 2020;
``retrain/LEAStereo.py``, ``retrain/new_model_2d.py``,
``retrain/skip_model_3d.py`` of the authors' code): a 2-D feature net of
decoded cells run on each view, the concatenated cost volume, a 3-D
matching net of decoded cells with two long skips, a trilinear 3x upsample
to ``maxdisp`` planes, softmin and the disparity regression. It takes its
architecture from a configuration file (``benchmark/configs``), works in
float32 by default, and imports nothing of the measured program.

Departures from the authors' code, each shared with the program it judges:

* train-mode BatchNorm moves its running variance towards the *biased*
  batch variance (the JAX package's flax semantics, which the port keeps);
* a cell creates ``pre_preprocess`` only where its channels change (the
  authors' code builds it always and skips it at run time), so the
  parameter names are those of the port's ``state_dict``.

``precision`` rounds each convolution's input and weight before it runs:
``"float32"`` leaves them, ``"bfloat16"`` rounds to bf16, ``"fp8"`` to
float8 e4m3 with one scale a tensor (its largest magnitude to 448), and in
training the gradient arriving at each convolution's output to float8 e5m2
(the usual fp8 training recipe). The sums run in float32. That makes the
reference the control of a precision below the configuration's.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Architecture", "Reference", "build_reference", "regress", "cost_volume", "exact_float32"]

FILTER_SCALE = (1, 2, 4, 8)  # level -> filter multiplier scale
SKIPS = ((1, 4), (4, 8))  # (source cell, target cell) of the matching net's long skips
_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


class Architecture:
    """A decoded sub-network: the level of each layer and the cell's
    ``(edge, op)`` rows (op 0 skip, 1 conv 3x3)."""

    def __init__(self, network_path, cell_genotype):
        self.network_path = tuple(int(v) for v in network_path)
        self.cell_genotype = tuple((int(e), int(o)) for e, o in cell_genotype)

    def downup(self, layer: int) -> int:
        prev = 0 if layer == 0 else self.network_path[layer - 1]
        return prev - self.network_path[layer]

    def edges(self) -> list[tuple[int, int]]:
        """Active edges in ascending order, each with the op of the genotype
        row at its position (the authors' cells build their ops in row order
        and consume them in edge order)."""
        return list(zip(sorted(e for e, _ in self.cell_genotype), (o for _, o in self.cell_genotype)))


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return x.to(dtype).float()
    scale = x.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX[dtype]
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """e4m3 forward; the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _quant(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return _round(x, torch.bfloat16)
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"precision {precision!r}")


def _scaled(n: int, scale: float) -> int:
    """The authors' odd-size rule: odd sizes stay on the corner grid."""
    return int((n - 1.0) * scale + 1.0) if n % 2 == 1 else int(n * scale)


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    if tuple(x.shape[2:]) == tuple(size):
        return x
    mode = "bilinear" if x.ndim == 4 else "trilinear"
    return F.interpolate(x, size=tuple(size), mode=mode, align_corners=True)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1: running statistics in eval; in training the
    batch's mean and biased variance, which the running ones move towards
    by ``momentum`` (0.1)."""

    def __init__(self, c: int):
        super().__init__()
        self.momentum = 0.1
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = [0, *range(2, x.ndim)]
            mean = x.mean(dims)
            var = (x - mean.view(shape)).square().mean(dims)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-5) * self.weight.view(shape) + self.bias.view(shape)


class ConvBR(nn.Module):
    def __init__(self, cin, cout, k, stride, pad, ndim, bn=True, relu=True, precision="float32"):
        super().__init__()
        conv = nn.Conv2d if ndim == 2 else nn.Conv3d
        self.conv = conv(cin, cout, k, stride, pad, bias=False)
        self.bn = BatchNorm(cout) if bn else None
        self.relu = relu
        self.precision = precision

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        fn = F.conv2d if c.weight.ndim == 4 else F.conv3d
        x = fn(_quant(x, self.precision), _quant(c.weight, self.precision), None, c.stride, c.padding)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class Cell(nn.Module):
    def __init__(self, arch: Architecture, steps, block, c_pp, c_p, c_out, downup, ndim, precision):
        super().__init__()
        kw = dict(ndim=ndim, precision=precision)
        self.steps, self.block, self.downup = steps, block, downup
        self.pre_preprocess = ConvBR(c_pp, c_out, 1, 1, 0, **kw) if c_pp != c_out else None
        self.preprocess = ConvBR(c_p, c_out, 1, 1, 0, **kw)
        self.edges = {}
        ops = []
        for pos, (edge, op) in enumerate(arch.edges()):
            self.edges[edge] = pos
            ops.append(ConvBR(c_out, c_out, 3, 1, 1, **kw) if op == 1 else nn.Identity())
        self._ops = nn.ModuleList(ops)

    def forward(self, s0, s1):
        prev = s1
        if self.downup:
            s1 = _resize(s1, [_scaled(n, 0.5 if self.downup == -1 else 2.0) for n in s1.shape[2:]])
        s0 = _resize(s0, s1.shape[2:])
        if self.pre_preprocess is not None:
            s0 = self.pre_preprocess(s0)
        states = [s0, self.preprocess(s1)]
        offset = 0
        for _ in range(self.steps):
            new = [self._ops[self.edges[offset + j]](h) for j, h in enumerate(states) if offset + j in self.edges]
            offset += len(states)
            states.append(sum(new[1:], new[0]))
        return prev, torch.cat(states[-self.block :], dim=1)


def _heads(module: nn.Module, level: int, c: int, ifm: int, ndim: int, precision: str) -> int:
    """The level-dependent 1x1 heads that bring the last cell back to 1/3."""
    for lvl, name, cout in ((3, "last_24", ifm * 4), (2, "last_12", ifm * 2), (1, "last_6", ifm)):
        if level >= lvl:
            module.add_module(name, ConvBR(c, cout, 1, 1, 0, ndim, precision=precision))
            c = cout
    return c


def _upsample_heads(module: nn.Module, level: int, x: torch.Tensor, full) -> torch.Tensor:
    for lvl, name, div in ((3, "last_24", 4), (2, "last_12", 2), (1, "last_6", 1)):
        if level >= lvl:
            x = _resize(getattr(module, name)(x), [n // div for n in full])
    return x


class Feature(nn.Module):
    def __init__(self, arch: Architecture, filt, block, steps, precision):
        super().__init__()
        ifm = filt * block
        kw = dict(ndim=2, precision=precision)
        self.level = arch.network_path[-1]
        self.stem0 = ConvBR(3, ifm // 2, 3, 1, 1, **kw)
        self.stem1 = ConvBR(ifm // 2, ifm, 3, 3, 1, **kw)
        self.stem2 = ConvBR(ifm, ifm, 3, 1, 1, **kw)
        cells, c_pp, c_p = [], ifm, ifm
        for i, level in enumerate(arch.network_path):
            c_out = filt * FILTER_SCALE[level]
            cells.append(Cell(arch, steps, block, c_pp, c_p, c_out, arch.downup(i), 2, precision))
            c_pp, c_p = c_p, block * c_out
        self.cells = nn.ModuleList(cells)
        c = _heads(self, self.level, c_p, ifm, 2, precision)
        self.last_3 = ConvBR(c, ifm, 1, 1, 0, bn=False, relu=False, **kw)

    def forward(self, x):
        s0 = self.stem1(self.stem0(x))
        s1 = self.stem2(s0)
        full = s1.shape[2:]
        for cell in self.cells:
            s0, s1 = cell(s0, s1)
        return self.last_3(_upsample_heads(self, self.level, s1, full))


class Matching(nn.Module):
    def __init__(self, arch: Architecture, fea_channels, filt, block, steps, precision):
        super().__init__()
        ifm = filt * block
        kw = dict(ndim=3, precision=precision)
        self.level = arch.network_path[-1]
        self.stem0 = ConvBR(2 * fea_channels, ifm, 3, 1, 1, **kw)
        self.stem1 = ConvBR(ifm, ifm, 3, 1, 1, **kw)
        self.skips = {tgt: (src, f"conv{k + 1}") for k, (src, tgt) in enumerate(SKIPS)}
        cells, concat, c_pp, c_p = [], [], ifm, ifm
        for i, level in enumerate(arch.network_path):
            c_out = filt * FILTER_SCALE[level]
            cells.append(Cell(arch, steps, block, c_pp, c_p, c_out, arch.downup(i), 3, precision))
            concat.append(block * c_out)
            c_pp, c_p = c_p, concat[-1]
            if i in self.skips:
                src, name = self.skips[i]
                self.add_module(name, ConvBR(concat[src] + concat[i], ifm * 2, 3, 1, 1, **kw))
                c_p = ifm * 2
        self.cells = nn.ModuleList(cells)
        c = _heads(self, self.level, concat[-1], ifm, 3, precision)
        self.last_3 = ConvBR(c, 1, 3, 1, 1, bn=False, relu=False, **kw)

    def forward(self, vol):
        s0 = self.stem0(vol)
        s1 = self.stem1(s0)
        full = s1.shape[2:]
        outs = []
        for i, cell in enumerate(self.cells):
            s0, s1 = cell(s0, s1)
            outs.append(s1)
            if i in self.skips:
                src, name = self.skips[i]
                s1 = getattr(self, name)(torch.cat([outs[src], s1], dim=1))
        return self.last_3(_upsample_heads(self, self.level, outs[-1], full))


def cost_volume(left: torch.Tensor, right: torch.Tensor, planes: int) -> torch.Tensor:
    """The concatenated volume ``(B, 2C, planes, h, w)``: at plane ``d`` the
    left features at columns ``>= d`` beside the right ones shifted by
    ``d``, zero elsewhere."""
    b, c, h, w = left.shape
    vol = left.new_zeros(b, 2 * c, planes, h, w)
    for d in range(min(planes, w)):
        vol[:, :c, d, :, d:] = left[..., d:]
        vol[:, c:, d, :, d:] = right[..., : w - d]
    return vol


def regress(cost: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """``(B, 1, D, h, w)`` cost -> ``(B, 3h, 3w)`` disparity: trilinear to
    ``(maxdisp, 3h, 3w)`` (align_corners=False), softmin over the planes,
    the expected plane index."""
    _, _, _, h, w = cost.shape
    x = F.interpolate(cost, size=(maxdisp, 3 * h, 3 * w), mode="trilinear", align_corners=False)[:, 0]
    p = torch.softmax(-x, dim=1)
    d = torch.arange(maxdisp, dtype=p.dtype, device=p.device).view(1, -1, 1, 1)
    return (p * d).sum(1)


class Reference(nn.Module):
    """``disparity = Reference(left, right)`` on NHWC ``(B, H, W, 3)`` views."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        super().__init__()
        f, m = cfg["feature"], cfg["matching"]
        self.maxdisp = cfg["maxdisp"]
        self.feature = Feature(
            Architecture(f["network_path"], f["cell_genotype"]),
            f["filter_multiplier"], f["block_multiplier"], f["steps"], precision,
        )
        self.matching = Matching(
            Architecture(m["network_path"], m["cell_genotype"]),
            f["filter_multiplier"] * f["block_multiplier"],
            m["filter_multiplier"], m["block_multiplier"], m["steps"], precision,
        )

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        fl = self.feature(left.permute(0, 3, 1, 2))
        fr = self.feature(right.permute(0, 3, 1, 2))
        return regress(self.matching(cost_volume(fl, fr, self.maxdisp // 3)), self.maxdisp)


def build_reference(cfg: dict, state: dict, device, precision: str = "float32", train: bool = False) -> Reference:
    """The reference of configuration ``cfg`` holding a copy of ``state``
    (parameter and buffer names as the port's ``state_dict``), on ``device``."""
    with torch.device("meta"):
        ref = Reference(cfg, precision)
    ref = ref.to_empty(device=device)
    ref.load_state_dict({k: v.to(device=device, dtype=torch.float32 if v.is_floating_point() else v.dtype)
                         for k, v in state.items()})
    return ref.train(train)


@contextlib.contextmanager
def exact_float32():
    """Float32 convolutions and products in float32, not TF32, for the span."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
