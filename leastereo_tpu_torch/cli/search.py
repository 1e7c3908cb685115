"""Bilevel NAS search driver (port of ``leastereo_tpu/cli/search.py``;
reference ``search.py``).

    python -m leastereo_tpu_torch.cli.search --dataset sceneflow_part \
        --listset sceneflow_part --crop_height 192 --crop_width 384

Weight steps (SGD, cosine per-iteration lr) on the ``search_weights`` split;
from ``--alpha_epoch`` on, one arch step (Adam) per weight step on the
``search_arch`` split; the eval-mode forward on the ``val`` split every
epoch. The supernet's head is the band kernel on the card
(``ops/fused_softargmin.py``) in every step and val frame. Checkpoints are
torch files (``run/<dataset>-search/<experiment>/checkpoints/{latest,best}/
<epoch>.pth``) holding the weights, the BN statistics and the alphas and
betas, which ``cli.decode`` reads.

``--mesh_data N`` runs the weight and arch steps data-parallel over N ranks
(``search/bilevel.py`` with the mesh; ranks as in ``cli/train.py``); rank 0
runs the val frames and writes the checkpoints and logs. ``--mesh_disp M``
replicates the work over M ranks, as the JAX driver does on that axis
(``leastereo_tpu/cli/search.py:62-66``): the supernet's volume is not
sharded, the disp ranks of a data row load the same rows and take the same
steps, and the steps reduce over the data group only.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..data import ListSet, StereoListDataset, make_loader
from ..models.leastereo import require_cuda
from ..parallel import Mesh, broadcast_module
from ..search import (
    AutoStereoSupernet,
    SupernetConfig,
    arch_step,
    cosine_iter_schedule,
    make_arch_optimizer,
    make_weight_optimizer,
    weight_step,
)
from ..train import eval_step
from ..utils.checkpoint import latest_checkpoint, load_state_dict_file, save_checkpoint
from ..utils.experiment import ExperimentSaver
from .common import MetricLogger, run_on_mesh
from .config import search_parser

__all__ = ["main", "build_supernet"]


def build_supernet(args) -> AutoStereoSupernet:
    """The supernet of the flags, initialised from ``--seed``, on
    ``--device``; ``--device cuda`` without a card raises."""
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda()
    model = AutoStereoSupernet(
        maxdisp=args.maxdisp,
        fea=SupernetConfig(args.fea_num_layers, args.fea_filter_multiplier, args.fea_block_multiplier, args.fea_step),
        mat=SupernetConfig(args.mat_num_layers, args.mat_filter_multiplier, args.mat_block_multiplier, args.mat_step),
        dtype=getattr(torch, args.dtype),
        generator=torch.Generator().manual_seed(args.seed),
    )
    return model.to(device)


def main(argv=None) -> int:
    args = search_parser().parse_args(argv)
    return run_on_mesh("leastereo_tpu_torch.cli.search", argv, args, lambda mesh: search(args, mesh))


def search(args, mesh: Mesh) -> int:
    """The search run of ``args`` as this process's rank of ``mesh``."""
    # First, so that --device cuda without a card raises before a file is written.
    model = build_supernet(args)
    device = next(model.parameters()).device
    broadcast_module(model, mesh)
    lead = mesh.rank == 0

    saver = None
    if lead:
        saver = ExperimentSaver(args.run_root, args.dataset, "search", args.experiment, resume=bool(args.resume))
        saver.save_parameters(args)
    log = MetricLogger(saver.logs_dir if lead else None, tensorboard=args.tensorboard and lead, echo=lead)

    lists = ListSet.resolve(args.listset, args.lists_dir)
    crop = (args.crop_height, args.crop_width)
    ds_kw = dict(dataset=args.dataset, root=args.data_root, seed=args.seed)
    weights_ds = StereoListDataset(list_file=lists.search_weights, crop_size=crop, training=True, **ds_kw)
    arch_ds = StereoListDataset(list_file=lists.search_arch, crop_size=crop, training=True, **ds_kw)
    val_ds = StereoListDataset(list_file=lists.val, crop_size=crop, training=False, **ds_kw)
    rows = dict(process_index=mesh.data_index, process_count=mesh.data)
    loader_w = make_loader(weights_ds, args.batch_size, device=device, seed=args.seed, num_workers=args.workers,
                           **rows)
    loader_a = make_loader(arch_ds, args.batch_size, device=device, seed=args.seed + 1, num_workers=args.workers,
                           **rows)
    val_loader = make_loader(val_ds, 1, device=device, shuffle=False, num_workers=args.workers, drop_last=False)
    if lead:
        print(f"supernet params: {sum(p.numel() for p in model.parameters()) / 1e6:.3f} M", flush=True)

    if args.resume:
        path = args.resume if os.path.isfile(args.resume) else latest_checkpoint(args.resume)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {args.resume}")
        kept = load_state_dict_file(path, model, tolerant=True)
        if lead:
            print(f"resumed from {path} ({len(kept)} tensors kept their initial value)", flush=True)

    steps_per_epoch = max(loader_w.steps_per_epoch, 1)
    schedule = cosine_iter_schedule(args.lr, args.epochs * steps_per_epoch, args.min_lr)
    opt_w = make_weight_optimizer(model.weight_parameters(), args.lr, args.momentum, args.weight_decay)
    opt_a = make_arch_optimizer(model.arch_parameters(), args.arch_lr, args.arch_weight_decay)

    best = float("inf")
    step = 0
    # The arch split is a plain cycle: pass k reshuffles with seed k, advancing
    # one batch per weight step regardless of epoch boundaries (reference
    # search.py alternation over the B split).
    arch_pass = 0
    arch_batches = None
    for epoch in range(args.epochs):
        use_arch = epoch >= args.alpha_epoch
        for epoch_step, batch in enumerate(loader_w(epoch)):
            metrics = weight_step(model, opt_w, batch, args.maxdisp, schedule(step), mesh)
            step += 1
            if use_arch:
                if arch_batches is None:
                    arch_batches = iter(loader_a(arch_pass))
                arch_batch = next(arch_batches, None)
                if arch_batch is None:
                    arch_pass += 1
                    arch_batches = iter(loader_a(arch_pass))
                    arch_batch = next(arch_batches)
                arch_step(model, opt_a, arch_batch, args.maxdisp, mesh)
            if step % 10 == 1:
                log.log(step, epoch=epoch, **metrics)
            if args.max_steps_per_epoch and epoch_step + 1 >= args.max_steps_per_epoch:
                break
        vals = [eval_step(model, batch, args.maxdisp)[1] for batch in val_loader(0)] if lead else []
        if vals:
            avg = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
            log.log(step, epoch=epoch, **{f"val_{k}": v for k, v in avg.items()})
            save_checkpoint(os.path.join(saver.checkpoint_dir, "latest"), epoch, model)
            if avg["err3"] < best:
                best = avg["err3"]
                save_checkpoint(os.path.join(saver.checkpoint_dir, "best"), epoch, model)
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
