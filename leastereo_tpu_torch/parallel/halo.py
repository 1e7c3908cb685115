"""Disparity-plane partitions and the halo exchange.

Under the JAX package's ``cost_volume_pspec`` XLA SPMD shards the volume's
disparity axis and inserts the ±1-plane halo exchanges of the 3x3x3
convolutions itself (``leastereo_tpu/parallel/mesh.py``). The port has no
GSPMD, so this module is that exchange, written by hand.

A :class:`DispPartition` splits one level's ``depth`` planes over the
``disp`` ranks near-evenly, as ``np.array_split`` does (the first
``depth % world`` ranks hold one plane more), so uneven splits work:
Middlebury's D = 136 in 4 shards is 34 planes a shard, and 34 at level 2
splits 9, 9, 8, 8. Every level of the matching net has its own partition
over the same group.

:func:`fetch_planes` gives each rank a range of global planes: its own,
its neighbours' and zeros outside ``[0, depth)``. The transfer is one
``all_reduce`` (sum) of a buffer that holds every plane any rank needs from
another, each written by its owner and zero elsewhere, so the sum is exact
in any dtype. ``all_reduce`` is the one collective that both NCCL and gloo
carry for CUDA tensors (gloo has no CUDA point-to-point); on gloo it stages
through the host. Every rank passes every rank's range: the buffer's layout
is computed on each rank and must agree.

The exchange is differentiable. Its adjoint is the transpose of the copy:
each rank packs the gradient of every plane it received into the same
segment buffer, one ``all_reduce`` carries it to the owners, and each owner
adds the segments it sent, and the gradient of the planes it copied
locally, into the gradient of its slab. So ``halo``, the sharded resize and
the sharded heads built on it have their backward, and every rank runs it
with the ranges of its forward.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

from .mesh import all_reduce

__all__ = ["DispPartition", "fetch_planes", "halo"]


@dataclasses.dataclass(frozen=True)
class DispPartition:
    """``depth`` planes over ``world`` ranks of ``group``; this is rank
    ``rank``'s view. ``group=None`` with ``world=1`` is the unsharded case."""

    depth: int
    world: int = 1
    rank: int = 0
    group: object | None = None

    def __post_init__(self):
        if self.depth < self.world:
            raise ValueError(f"{self.depth} planes over {self.world} ranks: each shard needs a plane")

    @property
    def bounds(self) -> list[tuple[int, int]]:
        """``[lo, hi)`` of every rank, as ``np.array_split``."""
        q, r = divmod(self.depth, self.world)
        out, lo = [], 0
        for i in range(self.world):
            hi = lo + q + (i < r)
            out.append((lo, hi))
            lo = hi
        return out

    @property
    def lo(self) -> int:
        return self.bounds[self.rank][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.rank][1]

    @property
    def count(self) -> int:
        return self.hi - self.lo

    def of_depth(self, depth: int) -> DispPartition:
        """The partition of another level's ``depth`` over the same ranks."""
        return dataclasses.replace(self, depth=depth)


def _segments(part: DispPartition, lo: Sequence[int], hi: Sequence[int]) -> list[tuple[int, int, int, int]]:
    """Every ``(destination, source, start, end)`` overlap of a rank's
    request with another rank's planes, in one order every rank computes
    alike: the layout of the exchange's buffer."""
    segments = []
    for dst in range(part.world):
        for src, (a, b) in enumerate(part.bounds):
            s, e = max(lo[dst], a), min(hi[dst], b)
            if src != dst and s < e:
                segments.append((dst, src, s, e))
    return segments


def _exchange(
    x: torch.Tensor, part: DispPartition, lo: Sequence[int], hi: Sequence[int], dim: int, adjoint: bool
) -> torch.Tensor:
    """The copy of :func:`fetch_planes` (``adjoint=False``: ``x`` is the
    slab, the result the planes ``[lo[me], hi[me])``) or its transpose
    (``adjoint=True``: ``x`` is the gradient of those planes, the result the
    gradient of the slab)."""
    me = part.rank
    own_lo, own_hi = part.bounds[me]
    segments = _segments(part, lo, hi)
    shape = list(x.shape)
    shape[dim] = own_hi - own_lo if adjoint else hi[me] - lo[me]
    out = x.new_zeros(shape)
    # Offsets of a global plane in the requested range and in the slab.
    req, slab = (lambda p: p - lo[me]), (lambda p: p - own_lo)
    get, put = (req, slab) if adjoint else (slab, req)

    def copy(dst_t, at, src_t, start, n, add=False):
        d = dst_t.narrow(dim, at, n)
        s = src_t.narrow(dim, start, n)
        d.add_(s) if add else d.copy_(s)

    s, e = max(lo[me], own_lo), min(hi[me], own_hi)
    if s < e:
        copy(out, put(s), x, get(s), e - s)
    if not segments:
        return out
    shape[dim] = sum(e - s for _, _, s, e in segments)
    buf = x.new_zeros(shape)
    # Forward: owners write, requesters read. Adjoint: requesters write the
    # gradient of what they read, owners add it to their planes.
    at = 0
    for dst, src, s, e in segments:
        if (dst if adjoint else src) == me:
            copy(buf, at, x, get(s), e - s)
        at += e - s
    all_reduce(buf, part.group)
    at = 0
    for dst, src, s, e in segments:
        if (src if adjoint else dst) == me:
            copy(out, put(s), buf, at, e - s, add=adjoint)
        at += e - s
    return out


class _FetchPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part, lo, hi, dim):
        ctx.args = (part, lo, hi, dim)
        return _exchange(x, part, lo, hi, dim, adjoint=False)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad.contiguous(), *ctx.args, adjoint=True), None, None, None, None


def fetch_planes(
    x: torch.Tensor, part: DispPartition, lo: Sequence[int], hi: Sequence[int], dim: int = 2
) -> torch.Tensor:
    """Global planes ``[lo[rank], hi[rank])`` along ``dim`` of the tensor
    whose ``part.rank`` slab is ``x`` (``x.shape[dim] == part.count``).

    ``lo`` and ``hi`` hold every rank's range, one entry per rank; planes
    outside ``[0, depth)`` are zeros. Every rank of ``part.group`` must call
    this with the same ``lo``, ``hi``, and so must its backward. Planes
    another rank owns arrive through one ``all_reduce``; none runs when no
    rank needs another's."""
    dim = dim % x.ndim
    if x.shape[dim] != part.count:
        raise ValueError(f"slab of {x.shape[dim]} planes along dim {dim}; rank {part.rank} owns {part.count}")
    return _FetchPlanes.apply(x, part, tuple(lo), tuple(hi), dim)


def halo(x: torch.Tensor, part: DispPartition, width: int = 1, dim: int = 2) -> torch.Tensor:
    """``x`` with ``width`` planes of each neighbour on either side (zeros
    beyond the global ends): the input of a depth-``2 * width + 1``
    convolution with no depth padding."""
    bounds = part.bounds
    return fetch_planes(x, part, [a - width for a, _ in bounds], [b + width for _, b in bounds], dim)
