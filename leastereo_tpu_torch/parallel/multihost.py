"""Multi-process setup (port of ``leastereo_tpu/parallel/multihost.py``).

* :func:`initialize`: ``torch.distributed.init_process_group`` with the
  address, world size and rank from its arguments or from the variables
  ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``); on the card ``LOCAL_RANK`` picks the device.
* per-process batch slicing: each rank loads only its rows of every global
  batch (``data/pipeline.py``, ``process_index`` / ``process_count``).
* :func:`make_global_batch`: this rank's rows onto its device, with no
  gather. The global batch exists only as the union of the ranks' rows; the
  steps reduce over the data group instead (``train/step.py``).

One process per rank is the PyTorch idiom (the JAX package drives every
local device from one process). The drivers take the rank from the
environment under ``torchrun`` or ``--multihost``, and otherwise spawn their
``data * disp`` local ranks themselves (``cli/common.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "process_info", "local_batch_size", "make_global_batch"]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str = "cuda",
) -> None:
    """Join the process group. ``coordinator_address`` is ``host:port``
    (default ``$MASTER_ADDR:$MASTER_PORT``), ``num_processes`` and
    ``process_id`` default to ``$WORLD_SIZE`` and ``$RANK``.

    ``backend`` defaults to ``nccl`` for ``device="cuda"`` and ``gloo`` for
    ``"cpu"``; naming ``gloo`` on ``cuda`` carries CUDA tensors over gloo
    (several ranks on one card, which NCCL refuses). On ``cuda`` the rank
    takes card ``$LOCAL_RANK`` (default: its rank); a rank without a card of
    its own raises, it never moves to the CPU."""
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator address: pass one or set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: cuda or cpu")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend == "nccl" and device != "cuda":
        raise ValueError("nccl carries CUDA tensors only: use gloo on the CPU")
    if device == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {process_id} wants card {local}, but {torch.cuda.device_count()} CUDA card(s) are visible"
            )
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id
    )


def process_info() -> tuple[int, int]:
    """(process_index, process_count): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_size(global_batch: int) -> int:
    _, count = process_info()
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} not divisible by {count} processes")
    return global_batch // count


def make_global_batch(local_batch: dict, device: torch.device | str) -> dict:
    """This rank's rows (numpy or tensors) as float32 tensors on ``device``;
    nothing crosses ranks."""
    return {
        k: torch.as_tensor(np.ascontiguousarray(v, np.float32) if isinstance(v, np.ndarray) else v).to(device)
        for k, v in local_batch.items()
    }
