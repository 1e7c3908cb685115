"""The ``(data, disp)`` process mesh (port of ``leastereo_tpu/parallel/mesh.py``).

The JAX package names a ``jax.sharding.Mesh`` with two axes and lets XLA
insert the collectives; here each mesh position is one process of a
``torch.distributed`` world, and the collectives are called by hand:

* ``data``: batch data-parallelism. Each rank holds its rows of the global
  batch; BatchNorm statistics, the loss's valid-pixel count, the gradients
  and the metrics are all-reduced over the data group (``train/step.py``,
  ``search/bilevel.py``).
* ``disp``: the disparity axis of the 5-D cost volume, the context-parallel
  analog for maxdisp-408 Middlebury frames. Each rank holds a slab of planes
  and the ±1-plane halos of the 3x3x3 convolutions go through
  ``parallel/halo.py``. In a disparity-sharded train step the matching
  net's BatchNorm statistics and the gradients are all-reduced over
  ``group``, which holds the ranks of both axes.

Ranks are laid out as JAX lays out devices,
``devices[:data * disp].reshape(data, disp)``: rank ``i_data * disp + i_disp``.
A 1x1 mesh needs no process group; in a world of one joined through a
launcher (``torchrun``, ``--multihost``) its axes reduce over that world.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "DISP_AXIS",
    "Mesh",
    "make_mesh",
    "all_reduce",
    "all_reduce_grads",
    "broadcast_module",
    "broadcast_object",
]

DATA_AXIS = "data"
DISP_AXIS = "disp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, disp)`` mesh and its groups:
    ``data_group`` holds the ranks of this rank's disp coordinate (one per
    data index), ``disp_group`` those of its data coordinate, and ``group``
    every rank of the mesh. A group is ``None`` where it holds one rank, so
    no collective runs over it, except in a launched world of one
    (:func:`make_mesh`)."""

    data: int
    disp: int
    rank: int = 0
    data_group: object | None = None
    disp_group: object | None = None
    group: object | None = None

    @property
    def data_index(self) -> int:
        return self.rank // self.disp

    @property
    def disp_index(self) -> int:
        return self.rank % self.disp

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, DISP_AXIS: self.disp}


def make_mesh(data: int | None = None, disp: int = 1) -> Mesh:
    """The ``(data, disp)`` mesh over the ``torch.distributed`` world (a
    world of one process without a process group). ``data=None`` takes every
    rank the ``disp`` axis leaves. Every rank must call this, in the same
    order as its other group creations: ``new_group`` is collective."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if data is None:
        if world % disp:
            raise ValueError(f"{world} ranks not divisible by disp={disp}")
        data = world // disp
    if data * disp > world:
        raise ValueError(f"mesh {data}x{disp} needs more than {world} ranks")
    if rank >= data * disp:
        raise ValueError(f"rank {rank} lies outside the {data}x{disp} mesh: launch data*disp ranks")
    if not initialized:
        return Mesh(1, 1)

    def groups(rows: list[list[int]]):
        """One group per row, created on every rank; this rank's group. An
        axis spanning the whole world reduces over it, even a world of one
        (so a one-rank run under a launcher still calls its collectives)."""
        if len(rows) == 1 and len(rows[0]) == world:
            return dist.group.WORLD
        if len(rows[0]) == 1:
            return None
        mine = None
        for ranks in rows:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    data_rows = [[i * disp + j for i in range(data)] for j in range(disp)]
    disp_rows = [[i * disp + j for j in range(disp)] for i in range(data)]
    return Mesh(data, disp, rank, groups(data_rows), groups(disp_rows), groups([list(range(data * disp))]))


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` over ``group``; nothing when the
    group is ``None`` (an axis of size 1). Not differentiable. Returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_grads(params, group) -> None:
    """Sum the gradients of ``params`` over ``group`` in one all_reduce of a
    flat buffer. Each rank's loss is its share of the global mean (its sum
    over the global count), so the sum is the gradient of the global loss."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


def broadcast_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Every parameter and buffer of ``module`` from rank 0 to all ranks, so
    the replicas start equal."""
    if mesh.data * mesh.disp == 1:
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t, src=0)


def broadcast_object(obj, mesh: Mesh):
    """A picklable value of rank 0, on every rank (the others' ``obj`` is
    ignored)."""
    if mesh.data * mesh.disp == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
