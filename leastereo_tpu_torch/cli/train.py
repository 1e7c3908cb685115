"""Retrain / fine-tune driver (port of ``leastereo_tpu/cli/train.py``;
reference ``train.py``).

    python -m leastereo_tpu_torch.cli.train --dataset kitti15_part \
        --listset kitti15_part --crop_height 288 --crop_width 576 \
        --batch_size 4 --maxdisp 192 --epochs 31 --loop_mode n_epochs

The host loop runs epochs, validation, early stopping, checkpoints and JSONL
metric logs. The train forward's head is the band kernel
(``ops/fused_softargmin.py``); validation runs the eval forward, whose head
is the fused head. Checkpoints are torch files
(``run/<dataset>-train/<experiment>/checkpoints/<kind>/<epoch>.pth``) that
``--resume`` and the predict and evaluate drivers' ``--checkpoint`` read.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..data import ListSet, StereoListDataset, make_loader
from ..models.leastereo import LEAStereo
from ..train import eval_step, make_lr_schedule, make_optimizer, train_step
from ..utils.checkpoint import latest_checkpoint, load_state_dict_file, save_checkpoint
from ..utils.experiment import EarlyStopping, ExperimentSaver
from .common import MetricLogger, build_model
from .config import train_parser

__all__ = ["main", "freeze_params"]


def freeze_params(model: LEAStereo, freeze_feature: bool, freeze_matching: int) -> list[str]:
    """Freeze parameters as the reference's transfer learning does
    (train.py:90-96, skip_model_3d.py:176-190; ``freeze_labels`` of the JAX
    package): ``freeze_feature`` freezes the whole feature net;
    ``freeze_matching=n`` the matching stems, the first n cells and each
    skip conv whose target cell is among them (``conv1`` into cell 4 when
    n >= 4, ``conv2`` into cell 8 when n >= 8). Frozen parameters stop
    requiring a gradient, so the optimizer leaves them out; their BN layers
    still update running stats in train mode, as in JAX. Returns the
    frozen names."""
    skip_target = {conv: tgt for tgt, (_, conv) in model.matching._skips.items()}

    def frozen(name: str) -> bool:
        net, mod, *rest = name.split(".")
        if freeze_feature and net == "feature":
            return True
        if freeze_matching and net == "matching":
            return (
                mod.startswith("stem")
                or (mod == "cells" and int(rest[0]) < freeze_matching)
                or (mod in skip_target and skip_target[mod] <= freeze_matching)
            )
        return False

    names = []
    for name, p in model.named_parameters():
        if frozen(name):
            p.requires_grad_(False)
            names.append(name)
    return names


def make_val_other(args, model: LEAStereo):
    """Extra fixed-list validation sweeps with a per-sweep z_shift
    (reference train.py:243-307 ``val_other``/``val_for``), one per
    ``--val_other name:dataset:list_file:data_root[:z_shift]``, through the
    predict driver's ``run_frame``. Returns ``run() -> [(name, metrics)]``
    or None."""
    specs = args.val_other or []
    if not specs:
        return None
    from .evaluate import frame_metrics
    from .predict import make_forward, run_frame

    sweeps = []
    for spec in specs:
        parts = spec.split(":")
        if len(parts) not in (4, 5):
            raise ValueError(f"--val_other expects name:dataset:list_file:data_root[:z_shift], got {spec!r}")
        name, dataset, list_file, root = parts[:4]
        z_shift = float(parts[4]) if len(parts) == 5 else 0.0
        ds = StereoListDataset(
            dataset=dataset, list_file=list_file, root=root,
            crop_size=(args.crop_height, args.crop_width), training=False,
        )
        sweeps.append((name, ds, z_shift))

    def run():
        model.eval()
        fwd = make_forward(model)
        out = []
        for name, ds, z_shift in sweeps:
            frames = []
            for i in range(len(ds)):
                stack = ds.load_stack(i)
                disp = run_frame(fwd, stack, args.crop_height, args.crop_width) + z_shift
                target = stack[6]
                th, tw = disp.shape
                oh = (target.shape[0] - th) // 2 if target.shape[0] > th else 0
                ow = (target.shape[1] - tw) // 2 if target.shape[1] > tw else 0
                frames.append(frame_metrics(disp, target[oh : oh + th, ow : ow + tw], args.maxdisp, ()))
            avg = {k: float(np.mean([f[k] for f in frames])) for k in ("epe", "err3")}
            print(f"===> val_other {name}: epe={avg['epe']:.4f} err3={avg['err3']:.4f}", flush=True)
            out.append((name, avg))
        return out

    return run


def main(argv=None) -> int:
    args = train_parser().parse_args(argv)
    # First, so that --device cuda without a card raises before a file is written.
    model = build_model(args, seed=args.seed)
    device = next(model.parameters()).device

    saver = ExperimentSaver(args.run_root, args.dataset, "train", args.experiment, resume=bool(args.resume))
    saver.save_parameters(args)
    log = MetricLogger(saver.logs_dir, tensorboard=args.tensorboard)

    lists = ListSet.resolve(args.listset, args.lists_dir)
    crop = (args.crop_height, args.crop_width)
    ds_kw = dict(dataset=args.dataset, root=args.data_root, seed=args.seed)
    train_ds = StereoListDataset(
        list_file=lists.train, crop_size=crop, training=True, shift=args.shift,
        left_right=args.left_right, **ds_kw,
    )
    val_ds = StereoListDataset(list_file=lists.val, crop_size=crop, training=False, **ds_kw)
    train_loader = make_loader(train_ds, args.batch_size, device=device, seed=args.seed, num_workers=args.workers)
    val_loader = make_loader(val_ds, args.test_batch_size, device=device, shuffle=False,
                             num_workers=args.workers, drop_last=False)
    print(f"model params: {sum(p.numel() for p in model.parameters()) / 1e6:.3f} M", flush=True)

    if args.resume:
        path = args.resume if os.path.isfile(args.resume) else latest_checkpoint(args.resume)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {args.resume}")
        kept = load_state_dict_file(path, model, tolerant=True)
        print(f"resumed from {path} ({len(kept)} tensors kept their initial value)", flush=True)
    frozen = freeze_params(model, bool(args.freeze_feature), args.freeze_matching)
    if frozen:
        print(f"frozen: {len(frozen)} parameter tensors", flush=True)

    schedule = make_lr_schedule(
        args.lr_scheduler, args.lr, args.epochs, max(train_loader.steps_per_epoch, 1),
        milestones=tuple(args.milestones), gamma=args.lr_gamma, lr_step=args.lr_step,
        warmup_epochs=args.warmup_epochs, min_lr=args.min_lr,
    )
    optimizer = make_optimizer([p for p in model.parameters() if p.requires_grad], args.solver, args.lr)

    def save(kind: str, epoch: int):
        save_checkpoint(os.path.join(saver.checkpoint_dir, kind), epoch, model)

    # n_epochs mode (reference train.py:393-429): fixed epoch count, no early
    # stop (patience past the last epoch); periodic saves gated on
    # --ckpt_min_epoch.
    n_epochs_mode = args.loop_mode == "n_epochs"
    early = EarlyStopping(
        args.epochs + 1 if n_epochs_mode else args.patience,
        0.0 if n_epochs_mode else args.es_delta,  # ref n_epochs: plain loss < best
        args.ckpt_period,
        save_fn=save,
    )
    if n_epochs_mode and args.ckpt_min_epoch:

        def gated_save(kind: str, epoch: int):
            if kind == "periodic" and epoch < args.ckpt_min_epoch:
                return
            save(kind, epoch)

        early.save_fn = gated_save

    val_other = make_val_other(args, model)

    step = 0
    for epoch in range(args.epochs):
        for epoch_step, batch in enumerate(train_loader(epoch)):
            metrics = train_step(model, optimizer, batch, args.maxdisp, schedule(step), args.edge_loss_w)
            step += 1
            if step % 10 == 1:
                log.log(step, epoch=epoch, **metrics)
            if args.max_steps_per_epoch and epoch_step + 1 >= args.max_steps_per_epoch:
                break
        vals = [eval_step(model, batch, args.maxdisp)[1] for batch in val_loader(0)]
        if val_other is not None:
            for name, m in val_other():
                log.log(step, epoch=epoch, **{f"val_{name}_{k}": v for k, v in m.items()})
        if vals:
            avg = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
            log.log(step, epoch=epoch, **{f"val_{k}": v for k, v in avg.items()})
            if early(avg["err3"], epoch + 1):
                print(f"early stop at epoch {epoch} (best {early.best:.4f} @ {early.best_epoch})", flush=True)
                break
    save("final", args.epochs)
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
