"""Profiling / tracing helpers (port of ``leastereo_tpu/utils/tracing.py``).

``torch.profiler`` traces in place of ``jax.profiler``: a Chrome trace
(``chrome://tracing``, Perfetto) of the host's operators and, when a card is
in use, its kernels; plus blocking wall-clock step timing.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "StepTimer", "device_memory_stats"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace('/tmp/trace') as prof: step()``. Writes
    ``<logdir>/trace.json``; where a card is present it holds the device's
    kernels too, synchronised before the trace ends. Yields the
    ``torch.profiler.profile`` for ``key_averages()``."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Blocking per-step wall-clock timing with warmup discard
    (reference per-iteration timing, train.py:151-169 / predict.py:227-233).
    A CUDA tensor given as ``result_to_block`` is waited for with
    ``torch.cuda.synchronize`` before the clock stops."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self, result_to_block=None):
        t0 = time.perf_counter()
        yield
        if isinstance(result_to_block, torch.Tensor) and result_to_block.is_cuda:
            torch.cuda.synchronize(result_to_block.device)
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def device_memory_stats(device=None) -> dict:
    """The caching allocator's statistics for a card (serving memory budget
    checks); empty on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
