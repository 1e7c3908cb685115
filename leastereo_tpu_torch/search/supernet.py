"""Multi-resolution trellis supernets and the full search model (port of
``leastereo_tpu/search/supernet.py``; reference ``models/build_model_2d.py``,
``build_model_3d.py``, ``build_model.py``).

One generic trellis: levels {0: 1/3, 1: 1/6, 2: 1/12, 3: 1/24}, level ``v``
first populated at layer ``v-1``, every (layer, level) node combining its
down/same/up branch outputs with normalized beta weights. The cells sit in
``cells`` in the reference's flat order (per layer, increasing level), so
a reference search checkpoint loads by name.

Beta normalization follows the reference's single-device path minus its two
bugs, as the JAX package does: zeros where the reference leaves
``torch.randn`` rows (never read), and ``beta[1][1][1]`` at layer 1 where the
reference reads ``beta[1][1][2]``.

Precision: parameters, BN statistics and the arch parameters stay float32;
the softmaxed alphas and normalized betas are cast to the compute dtype
before the mixed sums, and the convolutions run in it.

Remat (``SupernetConfig.remat``, on by default as in the JAX package): each
cell runs under ``torch.utils.checkpoint`` when a gradient is being
recorded, so its activations are recomputed in the backward pass. The
recomputation runs the cell's train-mode BatchNorm again, which would move
its running statistics a second time; the cell's buffers are put back to
their values from before the recomputation, so they move once per forward,
as flax's functional state does under ``nn.remat``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..models.genotypes import FILTER_SCALE, PRIMITIVES
from ..ops.convbr import ConvBR
from ..ops.cost_volume import build_cost_volume
from ..ops.fused_softargmin import soft_argmin_fused
from ..ops.resize import resize2d, resize3d
from .cells import SearchCell, num_edges

__all__ = [
    "SupernetConfig",
    "FeatureSupernet",
    "MatchingSupernet",
    "AutoStereoSupernet",
    "normalize_betas",
]


def first_layer(level: int) -> int:
    """Layer at which a level first produces output (stem = level 0 at -1)."""
    return -1 if level == 0 else level - 1


def normalize_betas(betas: torch.Tensor, num_layers: int) -> torch.Tensor:
    """(L, 4, 3) raw betas -> normalized transition weights, differentiable.

    Row layout: betas[l][u][k], k in {0: up, 1: same, 2: down}: the weight
    of the edge leaving level ``u`` at layer ``l`` in direction ``k``
    (reference build_model_2d.py:222-238, single-GPU path; bug-free
    variant, as ``normalize_betas`` of the JAX package).
    """
    out = torch.zeros_like(betas)
    for layer in range(num_layers):
        # Row 0 cannot go up: softmax over (same, down), scaled 2/3.
        out[layer, 0, 1:] = torch.softmax(betas[layer, 0, 1:], dim=-1) * (2.0 / 3.0)
        top = min(layer + 1, 3)  # highest level with output at layer-1
        for u in (1, 2):
            if u <= top:
                out[layer, u] = torch.softmax(betas[layer, u], dim=-1)
        if top == 3:
            # Row 3 cannot go down: softmax over (up, same), scaled 2/3.
            out[layer, 3, :2] = torch.softmax(betas[layer, 3, :2], dim=-1) * (2.0 / 3.0)
    return out


@dataclasses.dataclass(frozen=True)
class SupernetConfig:
    num_layers: int
    filter_multiplier: int
    block_multiplier: int
    steps: int = 3
    # Recompute each search cell in the backward pass (torch.utils.checkpoint),
    # as the JAX package's nn.remat; what the reference-scale 192x384
    # filter-4/block-3 search needs in memory.
    remat: bool = True


@contextlib.contextmanager
def _running_stats_kept(module: nn.Module):
    """Inside the block, changes to ``module``'s buffers (BN running
    statistics and counters) are undone on exit."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


class _Trellis(nn.Module):
    """Shared trellis machinery of the 2-D and 3-D supernets: the cells, the
    arch parameters ``alphas`` (num_edges, 2) and ``betas`` (L, 4, 3), both
    ``1e-3 * N(0, 1)`` from ``generator``, and the 4-level fusion head."""

    def __init__(self, cfg: SupernetConfig, ndim: int, stem_channels: int, generator: torch.Generator | None):
        super().__init__()
        self.cfg = cfg
        self.ndim = ndim
        fm, bm = cfg.filter_multiplier, cfg.block_multiplier
        self.alphas = nn.Parameter(1e-3 * torch.randn(num_edges(cfg.steps), len(PRIMITIVES), generator=generator))
        self.betas = nn.Parameter(1e-3 * torch.randn(cfg.num_layers, 4, 3, generator=generator))

        # Channels of each level's output at layer-1 / layer-2 (the stem is
        # level 0 at layer -1), and each cell's (layer, level) in flat order.
        prev = {0: stem_channels}
        prev_prev: dict[int, int] = {}
        cells: list[SearchCell] = []
        self._layers: list[list[tuple[int, int]]] = []  # per layer: (index in cells, level)
        for layer in range(cfg.num_layers):
            top = min(layer + 1, 3)
            new, nodes = {}, []
            for v in range(top + 1):
                has_s0 = layer - first_layer(v) >= 2
                srcs = (prev.get(v - 1), prev.get(v), prev.get(v + 1))
                if srcs == (None, None, None):
                    continue
                c_out = fm * FILTER_SCALE[v]
                nodes.append((len(cells), v))
                cells.append(SearchCell(cfg.steps, bm, prev_prev[v] if has_s0 else None, *srcs, c_out,
                                        ndim=ndim, generator=generator))
                new[v] = bm * c_out
            self._layers.append(nodes)
            prev_prev, prev = prev, new
        self.cells = nn.ModuleList(cells)

        kw = dict(ndim=ndim, generator=generator)
        num_end = fm * bm
        self.last_6 = ConvBR(2 * num_end, num_end, 1, 1, 0, **kw)
        self.last_12 = ConvBR(4 * num_end, 2 * num_end, 1, 1, 0, **kw)
        self.last_24 = ConvBR(8 * num_end, 4 * num_end, 1, 1, 0, **kw)

    def _call_cell(self, cell: SearchCell, *args) -> list[torch.Tensor]:
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return cell(*args)
        # The recomputation in the backward pass runs under a context that
        # keeps the running statistics the forward gave the cell.
        contexts = lambda: (contextlib.nullcontext(), _running_stats_kept(cell))  # noqa: E731
        return checkpoint(cell, *args, use_reentrant=False, context_fn=contexts)

    def trellis(self, stem_out: torch.Tensor) -> dict[int, torch.Tensor]:
        """Level outputs of the last layer, ``{level: (B, bm * c_out, ...)}``."""
        cfg = self.cfg
        dtype = stem_out.dtype
        a = torch.softmax(self.alphas, dim=-1).to(dtype)
        b = normalize_betas(self.betas, cfg.num_layers).to(dtype)

        # prev[v], prev_prev[v]: level outputs at layer-1 / layer-2.
        prev = {0: stem_out}
        prev_prev: dict[int, torch.Tensor] = {}
        for layer, nodes in enumerate(self._layers):
            new = {}
            for i, v in nodes:
                cell = self.cells[i]
                s1_down, s1_same, s1_up = prev.get(v - 1), prev.get(v), prev.get(v + 1)
                outs = self._call_cell(cell, prev_prev.get(v) if cell.has_s0 else None, s1_down, s1_same, s1_up, a)
                # Branch order mirrors availability order (down, same, up);
                # weight each with the beta of its transition.
                weights = []
                if s1_down is not None:
                    weights.append(b[layer, v - 1, 2])
                if s1_same is not None:
                    weights.append(b[layer, v, 1])
                if s1_up is not None:
                    weights.append(b[layer, v + 1, 0])
                new[v] = sum(w * o for w, o in zip(weights, outs))
            prev_prev, prev = prev, new
        return prev

    def fuse_head(self, levels: dict, stem_size: tuple[int, ...], last_3: ConvBR) -> torch.Tensor:
        """Progressive 4-level fusion (reference build_model_2d.py:406-418):
        each level is projected down the channel ladder and upsampled
        (align_corners=True) through the chain, then all four are summed."""
        resize = resize2d if self.ndim == 2 else resize3d
        up = functools.partial(resize, align_corners=True)
        half = tuple(d // 2 for d in stem_size)
        r3 = last_3(levels[0])
        r6 = last_3(up(self.last_6(levels[1]), stem_size))
        r12 = last_3(up(self.last_6(up(self.last_12(levels[2]), half)), stem_size))
        r24 = last_3(up(self.last_6(up(self.last_12(self.last_24(levels[3])), half)), stem_size))
        return r3 + r6 + r12 + r24


class FeatureSupernet(_Trellis):
    """2-D feature supernet (reference ``AutoFeature``, build_model_2d.py:60):
    a 3-conv stem (stride 1, 3, 1), the trellis and the fusion head.
    NCHW ``(B, 3, H, W)`` -> ``(B, fm * bm, H/3, W/3)``."""

    def __init__(self, cfg: SupernetConfig = SupernetConfig(6, 8, 4), generator: torch.Generator | None = None):
        num_end = cfg.filter_multiplier * cfg.block_multiplier
        half = (cfg.filter_multiplier // 2) * cfg.block_multiplier
        super().__init__(cfg, 2, num_end, generator)
        kw = dict(ndim=2, generator=generator)
        self.stem0 = ConvBR(3, half, 3, 1, 1, **kw)
        self.stem1 = ConvBR(half, half, 3, 3, 1, **kw)
        self.stem2 = ConvBR(half, num_end, 3, 1, 1, **kw)
        self.last_3 = ConvBR(num_end, num_end, 1, 1, 0, bn=False, relu=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stem = self.stem2(self.stem1(self.stem0(x)))
        return self.fuse_head(self.trellis(stem), tuple(stem.shape[2:]), self.last_3)


class MatchingSupernet(_Trellis):
    """3-D matching supernet (reference ``AutoMatching``, build_model_3d.py:10):
    stem0 on the concat volume, the trellis and the fusion head, whose
    ``last_3`` is a 3x3x3 conv to one channel. NCDHW ``(B, 2 * C_fea, D, h, w)``
    -> ``(B, 1, D, h, w)``."""

    def __init__(
        self,
        cfg: SupernetConfig = SupernetConfig(12, 8, 4),
        feature_channels: int = 32,
        generator: torch.Generator | None = None,
    ):
        num_end = cfg.filter_multiplier * cfg.block_multiplier
        super().__init__(cfg, 3, num_end, generator)
        kw = dict(ndim=3, generator=generator)
        self.stem0 = ConvBR(2 * feature_channels, num_end, 3, 1, 1, **kw)
        self.last_3 = ConvBR(num_end, 1, 3, 1, 1, bn=False, relu=False, **kw)

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        stem = self.stem0(volume)
        return self.fuse_head(self.trellis(stem), tuple(stem.shape[2:]), self.last_3)


class AutoStereoSupernet(nn.Module):
    """Full search-stage stereo model (reference ``AutoStereo``,
    build_model.py:10-79): the feature supernet on each view (one call per
    view, as the JAX model: in training each BN normalises with one view's
    statistics), the shifted-concat volume, the matching supernet, and the
    soft-argmin head through ``torch.ops.leastereo.band_soft_argmin``: the
    band kernel on a CUDA cost (a cost it refuses raises), the plain
    ``soft_argmin`` on a CPU one. NHWC ``(B, H, W, 3)`` images ->
    ``(B, H, W)`` fp32 disparity."""

    def __init__(
        self,
        maxdisp: int = 192,
        fea: SupernetConfig = SupernetConfig(6, 8, 4),
        mat: SupernetConfig = SupernetConfig(12, 8, 4),
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.maxdisp = maxdisp
        self.dtype = dtype
        self.feature = FeatureSupernet(fea, generator)
        self.matching = MatchingSupernet(mat, fea.filter_multiplier * fea.block_multiplier, generator)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        fl = self.feature(left.permute(0, 3, 1, 2).to(self.dtype))
        fr = self.feature(right.permute(0, 3, 1, 2).to(self.dtype))
        cost = self.matching(build_cost_volume(fl, fr, self.maxdisp // 3))
        return soft_argmin_fused(cost[:, 0], self.maxdisp)

    def arch_parameters(self) -> list[nn.Parameter]:
        """Alphas and betas of both sub-networks (reference
        ``arch_parameters()``, build_model_2d.py:438-442)."""
        return [self.feature.alphas, self.feature.betas, self.matching.alphas, self.matching.betas]

    def weight_parameters(self) -> list[nn.Parameter]:
        """Every other parameter (reference ``weight_parameters()``)."""
        arch = {id(p) for p in self.arch_parameters()}
        return [p for p in self.parameters() if id(p) not in arch]
