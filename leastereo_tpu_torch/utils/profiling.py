"""Parameter, FLOP and peak-memory accounting (port of
``leastereo_tpu/utils/profiling.py``).

The JAX package reads XLA's cost analysis of the compiled graph, which counts
every op. Here FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``,
which counts only matmuls and convolutions (multiply-adds as 2) plus the
formulas registered for the port's heads (``ops/fused_head.py``: the fused
head counts its ``last_3`` conv; the band kernel 0): elementwise work,
resizes and reductions count nothing, so the totals are below XLA's for the
same model. A model counts the same with its head fused or not.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

__all__ = [
    "count_params",
    "param_size_mb",
    "cost_analysis",
    "model_flops",
    "peak_hbm_gb",
    "device_peak_hbm_gb",
]


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def param_size_mb(model: nn.Module) -> float:
    """Parameter count in millions (reference count_parameters_in_MB,
    utils/multadds_count.py:8-9 — 'MB' there means 1e6 params)."""
    return count_params(model) / 1e6


def cost_analysis(fn, *args, **kwargs) -> dict:
    """Run ``fn`` once under ``FlopCounterMode`` -> ``{"flops": total}``."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": counter.get_total_flops()}


def model_flops(fn, *args, **kwargs) -> float:
    """Total FLOPs of one call of ``fn`` (multiply-adds count as 2)."""
    return float(cost_analysis(fn, *args, **kwargs)["flops"])


def peak_hbm_gb(device=None) -> float | None:
    """Peak device memory allocated by tensors since the last
    ``torch.cuda.reset_peak_memory_stats``, in GB; ``None`` on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 1e9, 3)


def device_peak_hbm_gb() -> float | None:
    """Peak device memory the caching allocator reserved on the current card
    (``memory_stats``), in GB; ``None`` without a card."""
    if not torch.cuda.is_available():
        return None
    peak = torch.cuda.memory_stats().get("reserved_bytes.all.peak", 0)
    return round(peak / 1e9, 3) if peak else None
