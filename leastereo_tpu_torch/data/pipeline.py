"""Host-to-device input pipeline (port of ``leastereo_tpu/data/pipeline.py``).

A thread pool decodes and augments samples on the host, batches are stacked
as numpy, and a prefetcher copies them to the device from pinned memory with
``non_blocking`` copies, ``depth`` batches in flight, so the copy of batch
N+1 overlaps the step on batch N. In a data-parallel run each process
loads only its rows of every global batch (``process_index`` /
``process_count``, as ``leastereo_tpu/data/pipeline.py:57-64``).
"""

from __future__ import annotations

import itertools
from collections.abc import Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .dataset import StereoListDataset

__all__ = ["batch_iterator", "prefetch_to_device", "make_loader"]


def batch_iterator(
    dataset: StereoListDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    epoch: int = 0,
    seed: int = 0,
    num_workers: int = 4,
    drop_last: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[dict]:
    """Yield batch dicts {left, right, disparity} of stacked numpy arrays.

    Shuffling is a seeded permutation per (seed, epoch); sample loading fans
    out over a thread pool (PIL/numpy release the GIL for decode/copy work).
    ``num_workers <= 0`` loads in the calling thread.

    Data-parallel: ``batch_size`` is the GLOBAL batch; with
    ``process_count > 1`` process ``process_index`` loads and yields only its
    ``batch_size / process_count`` contiguous rows of every global batch.
    The permutation is seeded alike on every process, so the global batches
    agree.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(order)
    n = len(order)
    if drop_last:
        n -= n % batch_size
        order = order[:n]
    if n == 0:
        return
    if process_count > 1:
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by {process_count} processes")
        if not drop_last and n % batch_size:
            raise ValueError("data-parallel loading requires drop_last")
        local = batch_size // process_count
        order = order.reshape(-1, batch_size)[:, process_index * local : (process_index + 1) * local].ravel()
        batch_size = local

    def load(i):
        return dataset.__getitem__(int(i), epoch=epoch)

    def emit(samples):
        while True:
            chunk = list(itertools.islice(samples, batch_size))
            if len(chunk) < batch_size and (drop_last or not chunk):
                return
            yield {
                "left": np.stack([s.left for s in chunk]),
                "right": np.stack([s.right for s in chunk]),
                "disparity": np.stack([s.disparity for s in chunk]),
            }

    if num_workers <= 0:
        yield from emit(map(load, order))
        return
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        yield from emit(pool.map(load, order))


def prefetch_to_device(it: Iterable[dict], device: torch.device | str, depth: int = 2) -> Iterator[dict]:
    """Batches of float32 tensors on ``device``, ``depth`` copies in flight.

    On a CUDA device the host arrays are pinned and copied with
    ``non_blocking=True`` (the caching host allocator keeps a pinned block
    until its copy has run)."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
            out[k] = (t.pin_memory() if pin else t).to(device, non_blocking=pin)
        return out

    queue: list = []
    for batch in it:
        queue.append(put(batch))
        if len(queue) >= depth:
            yield queue.pop(0)
    while queue:
        yield queue.pop(0)


def make_loader(
    dataset: StereoListDataset,
    batch_size: int,
    *,
    device: torch.device | str,
    shuffle: bool = True,
    seed: int = 0,
    num_workers: int = 4,
    drop_last: bool = True,
    process_index: int = 0,
    process_count: int = 1,
):
    """Epoch factory: ``loader(epoch) -> iterator`` of batches on ``device``,
    with ``steps_per_epoch``, ``dataset`` and ``batch_size`` attributes.
    ``batch_size`` is the global batch; each batch holds process
    ``process_index``'s rows of it (:func:`batch_iterator`)."""

    def epoch_iter(epoch: int) -> Iterator[dict]:
        batches = batch_iterator(
            dataset, batch_size, shuffle=shuffle, epoch=epoch, seed=seed,
            num_workers=num_workers, drop_last=drop_last,
            process_index=process_index, process_count=process_count,
        )
        return prefetch_to_device(batches, device)

    epoch_iter.dataset = dataset
    epoch_iter.batch_size = batch_size
    epoch_iter.steps_per_epoch = len(dataset) // batch_size if drop_last else -(-len(dataset) // batch_size)
    return epoch_iter
