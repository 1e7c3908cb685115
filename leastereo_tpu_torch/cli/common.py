"""Shared driver plumbing: model construction, metric logging and a
wall-clock timer (port of ``leastereo_tpu/cli/common.py``)."""

from __future__ import annotations

import json
import os
import time

import torch

from ..models.genotypes import BEST_SCENEFLOW, load_architecture
from ..models.leastereo import LEAStereo, LEAStereoConfig, require_cuda

__all__ = ["build_model", "MetricLogger", "Timer"]


def build_model(args, seed: int = 0) -> LEAStereo:
    """Model from arch .npy flags, falling back to the shipped best
    architecture (reference retrain/LEAStereo.py:16-21), initialised from
    ``seed``, in eval mode, on ``--device``. ``--device cuda`` without a card
    raises."""
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda()
    cfg = LEAStereoConfig(
        maxdisp=args.maxdisp,
        fea_filter_multiplier=args.fea_filter_multiplier,
        fea_block_multiplier=args.fea_block_multiplier,
        fea_steps=args.fea_step,
        mat_filter_multiplier=args.mat_filter_multiplier,
        mat_block_multiplier=args.mat_block_multiplier,
        mat_steps=args.mat_step,
        compute_dtype=args.dtype,
        fast_head=args.fast_head,
        return_entropy=getattr(args, "confidence", False),
    )
    if args.net_arch_fea and args.cell_arch_fea:
        fea = load_architecture(args.net_arch_fea, args.cell_arch_fea)
    else:
        fea = BEST_SCENEFLOW["feature"]
    if args.net_arch_mat and args.cell_arch_mat:
        mat = load_architecture(args.net_arch_mat, args.cell_arch_mat)
    else:
        mat = BEST_SCENEFLOW["matching"]
    model = LEAStereo(fea, mat, cfg, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


class MetricLogger:
    """stdout + JSONL scalar logging (``logs/metrics.jsonl``; replaces the
    reference's TensorBoard writer, train.py:100-101).

    ``tensorboard=True`` additionally writes TensorBoard event files next to
    the JSONL through tensorboardX; without it installed the flag is
    ignored with a warning."""

    def __init__(self, logs_dir: str | None, tensorboard: bool = False):
        self.path = None
        self._tb = None
        if logs_dir:
            os.makedirs(logs_dir, exist_ok=True)
            self.path = os.path.join(logs_dir, "metrics.jsonl")
            if tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(logs_dir)
                except ImportError:
                    print("tensorboardX not available; --tensorboard ignored")

    def log(self, step: int, **scalars) -> None:
        payload = {"step": int(step)}
        payload.update({k: float(v) for k, v in scalars.items()})
        line = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in payload.items())
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(payload) + "\n")
        if self._tb is not None:
            for k, v in payload.items():
                if k != "step":
                    self._tb.add_scalar(k, v, payload["step"])

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
