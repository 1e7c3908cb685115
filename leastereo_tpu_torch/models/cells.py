"""Fixed (decoded-genotype) cell for the 2-D feature and 3-D matching nets
(port of ``leastereo_tpu/models/cells.py``; reference
``retrain/new_model_2d.py:12-76`` and ``retrain/skip_model_3d.py:12-75``).

The cell rescales its two predecessors onto its resolution
(align_corners=True, odd-dim ``scale_dimension`` rule), 1x1-projects both to
``c_out``, runs a 3-step DAG whose active edges and primitives come from the
genotype, and concatenates the last ``block_multiplier`` states.

A 3-D cell runs on one rank's slab of a disparity-sharded volume when given
the partitions of its inputs: its resizes use the global D coordinates and
its 3x3x3 convolutions fetch their ±1-plane halos (``parallel/halo.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.convbr import ConvBR
from ..ops.layout import cat_channels
from ..ops.resize import resize2d, resize3d, scale_dimension
from ..parallel.halo import DispPartition
from .genotypes import OP_CONV, OP_SKIP, Architecture

__all__ = ["FixedCell", "cell_out_size"]


def cell_out_size(size: tuple[int, ...], downup_sample: int) -> tuple[int, ...]:
    """A cell's output size for a ``s1`` of spatial ``size``: halved
    (``downup_sample`` -1), kept (0) or doubled (+1) by ``scale_dimension``.
    Both inputs are resized to it, so a cell takes inputs of any size."""
    if downup_sample == 0:
        return tuple(size)
    scale = 0.5 if downup_sample == -1 else 2.0
    return tuple(scale_dimension(d, scale) for d in size)


class FixedCell(nn.Module):
    """One decoded cell. Submodule names follow the reference
    (``pre_preprocess``, ``preprocess``, ``_ops.K``); ``_ops`` holds an
    ``nn.Identity`` at each skip position so conv indices match."""

    def __init__(
        self,
        steps: int,
        block_multiplier: int,
        c_prev_prev: int,
        c_prev: int,
        c_out: int,
        downup_sample: int,
        genotype: Architecture,
        ndim: int,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.steps = steps
        self.block_multiplier = block_multiplier
        self.downup_sample = downup_sample
        self.ndim = ndim
        kw = dict(ndim=ndim, generator=generator)
        if c_prev_prev != c_out:
            self.pre_preprocess = ConvBR(c_prev_prev, c_out, 1, 1, 0, **kw)
        else:
            self.pre_preprocess = None
        self.preprocess = ConvBR(c_prev, c_out, 1, 1, 0, **kw)
        # Ops pair with edges positionally: row-order ops, consumed in
        # ascending-edge order (Architecture.active_edges).
        self._edges = {}
        ops = []
        for seq, (edge, op) in enumerate(genotype.active_edges()):
            self._edges[edge] = seq
            if op == OP_SKIP:
                ops.append(nn.Identity())
            else:
                assert op == OP_CONV, op
                ops.append(ConvBR(c_out, c_out, 3, 1, 1, **kw))
        self._ops = nn.ModuleList(ops)

    def _resize(self, x: torch.Tensor, size: tuple[int, ...], part: DispPartition | None) -> torch.Tensor:
        return resize2d(x, size) if self.ndim == 2 else resize3d(x, size, part=part)

    def _project_resize(
        self, x: torch.Tensor, size: tuple[int, ...], conv: ConvBR | None, part: DispPartition | None
    ) -> torch.Tensor:
        """Resize to ``size`` and 1x1-project. Reference order is resize ->
        conv -> BN -> ReLU; in eval, conv + BN are channel-affine and the
        resize is a convex spatial blend, so when upsampling the projection
        runs first on the smaller tensor, as in the JAX package. ``part``:
        the partition of ``x`` when it is a slab of a sharded volume."""
        shape = tuple(x.shape[2:]) if part is None else (part.depth, *x.shape[3:])
        need_resize = shape != tuple(size)
        if conv is None:
            return self._resize(x, size, part) if need_resize else x
        if need_resize and size[-1] > x.shape[-1] and not self.training:
            return torch.relu(self._resize(conv.eval_conv(x, relu=False), size, part))
        if need_resize:
            x = self._resize(x, size, part)
        return conv(x)

    def out_size(self, size: tuple[int, ...]) -> tuple[int, ...]:
        """The cell's output size for a ``s1`` of spatial ``size``."""
        return cell_out_size(size, self.downup_sample)

    def forward(
        self,
        s0: torch.Tensor,
        s1: torch.Tensor,
        parts: tuple[DispPartition, DispPartition] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``parts``: the depth partitions of ``s0`` and ``s1`` when they are
        one rank's slabs of disparity-sharded volumes; the output is then
        that rank's slab at the cell's depth."""
        prev_input = s1
        if parts is None:
            size = self.out_size(s1.shape[2:])
            p0 = p1 = part = None
        else:
            p0, p1 = parts
            size = self.out_size((p1.depth, *s1.shape[3:]))
            part = p1.of_depth(size[0])
        s0 = self._project_resize(s0, size, self.pre_preprocess, p0)
        s1 = self._project_resize(s1, size, self.preprocess, p1)

        states = [s0, s1]
        offset = 0
        for _ in range(self.steps):
            new_states = []
            for j, h in enumerate(states):
                seq = self._edges.get(offset + j)
                if seq is not None:
                    op = self._ops[seq]
                    new_states.append(op(h) if isinstance(op, nn.Identity) else op(h, part))
            offset += len(states)
            states.append(sum(new_states[1:], new_states[0]))
        return prev_input, cat_channels(states[-self.block_multiplier :])
