"""Decoded 3-D Matching Net with long skip connections (port of
``leastereo_tpu/models/matching_net.py``; reference
``retrain/skip_model_3d.py:78-174``).

Filters the stereo features through the fused cost-volume stem0, stem1,
``num_layers`` decoded 3-D cells (with the long skips
``conv1(cat(out1, out4))`` feeding cell 5 and ``conv2(cat(out4, out8))``
feeding cell 9) and the level-dependent upsample head. ``forward`` ends at
the pre-head volume; the ``last_3`` conv (C -> 1) is applied by the caller's
head (``models/leastereo.py``), which may fuse it into a kernel.

Given a :class:`~leastereo_tpu_torch.parallel.DispPartition` of the
volume's D planes, ``forward`` computes one rank's slab of every volume
(the CP analog of the JAX package's ``volume_pspec``): the stem builds its
planes from the features, each level takes its own partition of that
level's depth, and the 3x3x3 convolutions and resizes exchange the planes
they need (``parallel/halo.py``), in eval and in training.

Layout: in the eval, unsharded forward the volumes are NDHWC
(``torch.channels_last_3d``; :meth:`MatchingNet.layout`) from the stem's
output, which the fused stem writes so, to the last upsampling resize: every
3-D ConvBR, concat and resize below follows its input's layout
(``ops/convbr.py``, ``ops/layout.py``, ``ops/resize.py``), so cuDNN
convolves in place, with no transposes; that last resize writes the NCDHW
volume the head reads. Training and the sharded paths stay NCDHW throughout.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.convbr import ConvBR
from ..ops.cost_volume import build_cost_volume
from ..ops.fused_stem import fused_cost_volume_stem
from ..ops.layout import cat_channels
from ..ops.resize import resize3d
from ..parallel.halo import DispPartition
from ..utils.tracing import span
from .cells import FixedCell
from .genotypes import FILTER_SCALE, Architecture

__all__ = ["MatchingNet", "FusedStem0", "DEFAULT_SKIPS"]

# (source_cell, target_cell): after target's concat, fuse with source's
# concat through a 3x3x3 ConvBR (reference skip_model_3d.py:150-156). The
# k-th skip's conv is named ``conv{k+1}`` as in the reference.
DEFAULT_SKIPS = ((1, 4), (4, 8))


class FusedStem0(ConvBR):
    """Cost volume + stem0 ConvBR (conv + BN + ReLU). With ``fused``, in eval,
    the volume is never built (``ops/fused_stem.py``): the BN scale folds into
    the kernel and bias + ReLU ride the assembly's epilogue. Otherwise, and in
    training, the explicit volume goes through the ConvBR. Same ``conv``/``bn``
    parameters either way.

    Given a partition, the stem computes rank ``part.rank``'s planes: fused,
    through the fused stem's plane range; explicit, from the volume's planes
    ``[lo - 1, hi + 1)``, which the rank builds from the features it holds
    (zeros outside ``[0, num_disp)``), convolved with no depth padding. No
    exchange: both views' features are on every rank."""

    def __init__(self, feature_channels: int, out_channels: int, generator: torch.Generator | None = None):
        super().__init__(2 * feature_channels, out_channels, 3, 1, 1, ndim=3, generator=generator)

    def forward(
        self,
        left: torch.Tensor,
        right: torch.Tensor,
        num_disp: int,
        fused: bool = True,
        part: DispPartition | None = None,
        memory_format: torch.memory_format = torch.contiguous_format,
    ):
        """``part``: compute only rank ``part.rank``'s planes; unsharded, the
        output is laid out as ``memory_format`` says (NCDHW or NDHWC)."""
        if fused and not self.training:
            weight, bias = self.folded()
            planes = None if part is None else (part.lo, part.hi)
            return fused_cost_volume_stem(left, right, weight, num_disp, bias=bias, relu=True, planes=planes,
                                          memory_format=memory_format)
        if part is None:
            return super().forward(build_cost_volume(left, right, num_disp)).contiguous(memory_format=memory_format)
        return self.haloed(build_cost_volume(left, right, num_disp, planes=(part.lo - 1, part.hi + 1)))


class MatchingNet(nn.Module):
    def __init__(
        self,
        genotype: Architecture,
        feature_channels: int,
        filter_multiplier: int = 8,
        block_multiplier: int = 4,
        steps: int = 3,
        skips: tuple[tuple[int, int], ...] = DEFAULT_SKIPS,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        kw = dict(ndim=3, generator=generator)
        ifm = filter_multiplier * block_multiplier
        self.genotype = genotype
        self.skips = tuple(skips)
        self.level = genotype.network_path[-1]
        self.stem0 = FusedStem0(feature_channels, ifm, generator=generator)
        self.stem1 = ConvBR(ifm, ifm, 3, 1, 1, **kw)

        self._skips = {tgt: (src, f"conv{k + 1}") for k, (src, tgt) in enumerate(skips)}
        cells = []
        concat_ch = []
        c_pp, c_p = ifm, ifm
        for i, level in enumerate(genotype.network_path):
            c_out = filter_multiplier * FILTER_SCALE[level]
            cells.append(
                FixedCell(steps, block_multiplier, c_pp, c_p, c_out, genotype.downup(i), genotype, **kw)
            )
            concat_ch.append(block_multiplier * c_out)
            c_pp, c_p = c_p, concat_ch[-1]
            if i in self._skips:
                src, name = self._skips[i]
                self.add_module(name, ConvBR(concat_ch[src] + concat_ch[i], ifm * 2, 3, 1, 1, **kw))
                c_p = ifm * 2
        self.cells = nn.ModuleList(cells)

        c = concat_ch[-1]
        if self.level >= 3:
            self.last_24 = ConvBR(c, ifm * 4, 1, 1, 0, **kw)
            c = ifm * 4
        if self.level >= 2:
            self.last_12 = ConvBR(c, ifm * 2, 1, 1, 0, **kw)
            c = ifm * 2
        if self.level >= 1:
            self.last_6 = ConvBR(c, ifm, 1, 1, 0, **kw)
            c = ifm
        self.last_3 = ConvBR(c, 1, 3, 1, 1, bn=False, relu=False, **kw)

    def layout(self, part: DispPartition | None) -> torch.memory_format:
        """The volumes' layout: NDHWC in the eval, unsharded forward, NCDHW
        in training and on a slab of a sharded volume."""
        return torch.channels_last_3d if not self.training and part is None else torch.contiguous_format

    def forward(
        self,
        left: torch.Tensor,
        right: torch.Tensor,
        num_disp: int,
        fused_stem: bool = True,
        part: DispPartition | None = None,
    ) -> torch.Tensor:
        """NCHW features ``(B, C, h, w)`` of both views -> the pre-head volume
        ``(B, ifm, num_disp, h, w)`` (input of ``last_3``); with ``part`` (of
        ``num_disp`` planes), rank ``part.rank``'s slab of it. The result is
        NCDHW-contiguous (module docstring)."""
        d, h, w = num_disp, left.shape[2], left.shape[3]
        with span("stem"):
            stem0 = self.stem0(left, right, num_disp, fused=fused_stem, part=part, memory_format=self.layout(part))
        stem1 = self.stem1(stem0, part)

        concats: list[torch.Tensor] = []
        parts: list[DispPartition | None] = []
        s0, s1 = stem0, stem1
        p0 = p1 = part
        for i, cell in enumerate(self.cells):
            prev_raw, concat = cell(s0, s1, None if part is None else (p0, p1))
            p_out = None if part is None else p1.of_depth(cell.out_size((p1.depth,))[0])
            concats.append(concat)
            parts.append(p_out)
            if i in self._skips:
                src, name = self._skips[i]
                concat = getattr(self, name)(cat_channels([concats[src], concat]), p_out)
            s0, s1 = prev_raw, concat
            p0, p1 = p1, p_out

        last, p_last = concats[-1], parts[-1]
        for lvl, div, conv in ((3, 4, "last_24"), (2, 2, "last_12"), (1, 1, "last_6")):
            if self.level >= lvl:
                # The last resize writes the NCDHW volume the head reads.
                fmt = torch.contiguous_format if lvl == 1 else None
                last = resize3d(getattr(self, conv)(last), (d // div, h // div, w // div), part=p_last,
                                memory_format=fmt)
                p_last = None if part is None else part.of_depth(d // div)
        return last.contiguous()
