"""Parallel runs of the port (port of ``leastereo_tpu/parallel``): the
``(data, disp)`` process mesh and its collectives (``mesh.py``), process
setup and batch slicing (``multihost.py``), and the hand-written halo
exchange of the disparity-sharded volume (``halo.py``)."""

from .halo import DispPartition, fetch_planes, halo
from .mesh import (
    DATA_AXIS,
    DISP_AXIS,
    Mesh,
    all_reduce,
    all_reduce_grads,
    broadcast_module,
    broadcast_object,
    make_mesh,
)
from .multihost import initialize, local_batch_size, make_global_batch, process_info

__all__ = [
    "DATA_AXIS",
    "DISP_AXIS",
    "Mesh",
    "make_mesh",
    "all_reduce",
    "all_reduce_grads",
    "broadcast_module",
    "broadcast_object",
    "DispPartition",
    "fetch_planes",
    "halo",
    "initialize",
    "process_info",
    "local_batch_size",
    "make_global_batch",
]
