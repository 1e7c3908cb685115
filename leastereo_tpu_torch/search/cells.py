"""Searchable (DARTS-style) cell shared by the 2-D and 3-D supernets (port of
``leastereo_tpu/search/cells.py``; reference
``models/cell_level_search_2d.py`` / ``cell_level_search_3d.py``).

A cell owns one set of mixed-op weights for its DAG and applies it to each
*branch* (the down/same/up-resampled outputs of the previous layer),
returning one tensor per branch; the supernet weights the branch outputs
with its betas. Every mixed edge computes both primitives, skip and
conv3x3, weighted by the softmaxed alphas: ``w0 * h + w1 * ConvBR(h)``.

Module names are the reference's (``preprocess_down``, ``preprocess_same``,
``preprocess_up``, ``pre_preprocess``, and edge ``e``'s conv as
``_ops.{e}._ops.1``), so a reference search checkpoint loads by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..models.genotypes import PRIMITIVES
from ..ops.convbr import ConvBR
from ..ops.resize import resize2d, resize3d, scale_dimension

__all__ = ["SearchCell", "MixedOp", "num_edges", "s0_edge_indices"]


def num_edges(steps: int) -> int:
    """Total DAG edges: node i has 2+i inputs (reference
    build_model_2d.py:421)."""
    return sum(2 + i for i in range(steps))


def s0_edge_indices(steps: int) -> tuple[int, ...]:
    """Edge indices fed by the layer-2 state s0 (first input of each node's
    first-two states block): {0, 2, 5} for steps=3."""
    out, offset, n = [], 0, 2
    for _ in range(steps):
        out.append(offset)
        offset += n
        n += 1
    return tuple(out)


class MixedOp(nn.Module):
    """One edge's relaxation ``w[0] * h + w[1] * conv(h)``: ``_ops`` holds the
    parameterless skip at index 0 and the ConvBR at index 1, in
    ``PRIMITIVES`` order (reference ``MixedOp``)."""

    def __init__(self, channels: int, ndim: int, generator: torch.Generator | None = None):
        super().__init__()
        assert PRIMITIVES == ("skip_connect", "conv_3x3")
        self._ops = nn.ModuleList([nn.Identity(), ConvBR(channels, channels, 3, 1, 1, ndim=ndim, generator=generator)])

    def forward(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return w[0] * h + w[1] * self._ops[1](h)


class SearchCell(nn.Module):
    """One searchable cell at a (layer, level) trellis node.

    ``c_prev_down`` / ``c_prev_same`` / ``c_prev_up`` are the channels of the
    branches this node receives (``None`` where the branch is absent), and
    ``c_prev_prev`` those of the layer-2 state s0 (``None`` when the cell has
    no s0: it then builds no s0 edges, ``_ops.{e}`` is ``None`` there, as the
    reference's ``op=None``, cell_level_search_2d.py:63-70). Branch inputs
    are resampled with the align_corners=True / ``scale_dimension`` rule and
    1x1-projected to ``c_out``; the shared DAG runs per branch.
    """

    def __init__(
        self,
        steps: int,
        block_multiplier: int,
        c_prev_prev: int | None,
        c_prev_down: int | None,
        c_prev_same: int | None,
        c_prev_up: int | None,
        c_out: int,
        ndim: int = 2,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.steps = steps
        self.block_multiplier = block_multiplier
        self.ndim = ndim
        self.has_s0 = c_prev_prev is not None
        kw = dict(ndim=ndim, generator=generator)
        for name, c in (("preprocess_down", c_prev_down), ("preprocess_same", c_prev_same), ("preprocess_up", c_prev_up)):
            setattr(self, name, None if c is None else ConvBR(c, c_out, 1, 1, 0, **kw))
        need_pre = self.has_s0 and c_prev_prev != c_out
        self.pre_preprocess = ConvBR(c_prev_prev, c_out, 1, 1, 0, **kw) if need_pre else None
        skip_edges = set() if self.has_s0 else set(s0_edge_indices(steps))
        self._ops = nn.ModuleList(
            [None if e in skip_edges else MixedOp(c_out, ndim, generator) for e in range(num_edges(steps))]
        )

    def _resize(self, x: torch.Tensor, size: tuple[int, ...]) -> torch.Tensor:
        return (resize2d if self.ndim == 2 else resize3d)(x, size, align_corners=True)

    def forward(
        self,
        s0: torch.Tensor | None,
        s1_down: torch.Tensor | None,
        s1_same: torch.Tensor | None,
        s1_up: torch.Tensor | None,
        alphas: torch.Tensor,
    ) -> list[torch.Tensor]:
        """``alphas``: ``(num_edges, 2)``, already softmaxed. Returns one
        ``(B, block_multiplier * c_out, *spatial)`` tensor per present
        branch, in the order down, same, up."""
        branches = []
        if s1_down is not None:
            size = tuple(scale_dimension(d, 0.5) for d in s1_down.shape[2:])
            branches.append(self.preprocess_down(self._resize(s1_down, size)))
        if s1_same is not None:
            branches.append(self.preprocess_same(s1_same))
        if s1_up is not None:
            size = tuple(scale_dimension(d, 2.0) for d in s1_up.shape[2:])
            branches.append(self.preprocess_up(self._resize(s1_up, size)))
        target_size = tuple(branches[-1].shape[2:])

        if self.has_s0:
            if tuple(s0.shape[2:]) != target_size:
                s0 = self._resize(s0, target_size)
            if self.pre_preprocess is not None:
                s0 = self.pre_preprocess(s0)

        outs = []
        for branch in branches:
            states = [s0 if self.has_s0 else None, branch]
            offset = 0
            for _ in range(self.steps):
                acc = [self._ops[offset + j](h, alphas[offset + j])
                       for j, h in enumerate(states) if h is not None and self._ops[offset + j] is not None]
                offset += len(states)
                states.append(sum(acc[1:], acc[0]))
            outs.append(torch.cat(states[-self.block_multiplier :], dim=1))
        return outs
