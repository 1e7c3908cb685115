"""Decoded 2-D Feature Net (port of ``leastereo_tpu/models/feature_net.py``;
reference ``retrain/new_model_2d.py:78-165``).

A 3-conv stem (stride 1, 3, 1), ``num_layers`` decoded cells along the
searched resolution path, then a level-dependent 1x1-conv + bilinear
upsample head returning NCHW features at 1/3 resolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.convbr import ConvBR
from ..ops.resize import resize2d
from .cells import FixedCell
from .genotypes import FILTER_SCALE, Architecture

__all__ = ["FeatureNet"]


class FeatureNet(nn.Module):
    def __init__(
        self,
        genotype: Architecture,
        filter_multiplier: int = 8,
        block_multiplier: int = 4,
        steps: int = 3,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        kw = dict(ndim=2, generator=generator)
        ifm = filter_multiplier * block_multiplier
        self.genotype = genotype
        self.level = genotype.network_path[-1]
        self.stem0 = ConvBR(3, ifm // 2, 3, 1, 1, **kw)
        self.stem1 = ConvBR(ifm // 2, ifm, 3, 3, 1, **kw)
        self.stem2 = ConvBR(ifm, ifm, 3, 1, 1, **kw)
        cells = []
        c_pp, c_p = ifm, ifm
        for i, level in enumerate(genotype.network_path):
            c_out = filter_multiplier * FILTER_SCALE[level]
            cells.append(
                FixedCell(steps, block_multiplier, c_pp, c_p, c_out, genotype.downup(i), genotype, **kw)
            )
            c_pp, c_p = c_p, block_multiplier * c_out
        self.cells = nn.ModuleList(cells)
        # Level-dependent head (reference new_model_2d.py:150-163).
        if self.level >= 3:
            self.last_24 = ConvBR(c_p, ifm * 4, 1, 1, 0, **kw)
            c_p = ifm * 4
        if self.level >= 2:
            self.last_12 = ConvBR(c_p, ifm * 2, 1, 1, 0, **kw)
            c_p = ifm * 2
        if self.level >= 1:
            self.last_6 = ConvBR(c_p, ifm, 1, 1, 0, **kw)
            c_p = ifm
        self.last_3 = ConvBR(c_p, ifm, 1, 1, 0, bn=False, relu=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: NCHW images ``(B, 3, H, W)`` -> ``(B, 32, H/3, W/3)``."""
        stem1 = self.stem1(self.stem0(x))
        stem2 = self.stem2(stem1)
        s0, s1 = stem1, stem2
        for cell in self.cells:
            s0, s1 = cell(s0, s1)
        last = s1
        h, w = stem2.shape[2], stem2.shape[3]
        # The //2, //4 targets use integer division of the stem size.
        if self.level >= 3:
            last = resize2d(self.last_24(last), (h // 4, w // 4))
        if self.level >= 2:
            last = resize2d(self.last_12(last), (h // 2, w // 2))
        if self.level >= 1:
            last = resize2d(self.last_6(last), (h, w))
        return self.last_3(last)
