"""Shared driver plumbing: model construction and a wall-clock timer
(port of ``leastereo_tpu/cli/common.py``)."""

from __future__ import annotations

import time

import torch

from ..models.genotypes import BEST_SCENEFLOW, load_architecture
from ..models.leastereo import LEAStereo, LEAStereoConfig, require_cuda

__all__ = ["build_model", "Timer"]


def build_model(args) -> LEAStereo:
    """Model from arch .npy flags, falling back to the shipped best
    architecture (reference retrain/LEAStereo.py:16-21), initialised from
    seed 0, in eval mode, on ``--device``. ``--device cuda`` without a card
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
    model = LEAStereo(fea, mat, cfg, torch.Generator().manual_seed(0))
    return model.to(device).eval()


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
