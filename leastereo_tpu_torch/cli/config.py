"""argparse configuration for the port's CLI drivers.

The flags, names and defaults of ``leastereo_tpu/cli/config.py`` (reference
``config_utils/*.py``), except that ``--platform {cpu,tpu}`` becomes
``--device {cuda,cpu}`` (default ``cuda``). The mesh flags (``--mesh_data``,
``--mesh_disp``, ``--multihost``) wait for the port's parallel runs.
"""

from __future__ import annotations

import argparse

__all__ = ["add_model_args", "add_data_args", "train_parser", "predict_parser", "evaluate_parser"]

DATASETS = [
    "sceneflow",
    "kitti15",
    "kitti15_part",
    "kitti12",
    "middlebury",
    "sceneflow_part",
    "sceneflow_legacy",
    "satellite",
    "dfc2019",
    "new_tagil",
    "whu",
    "whu2new_tagil",
]


def add_model_args(p: argparse.ArgumentParser, with_arch_files: bool = True) -> None:
    """Architecture shape flags (reference config_utils/leastereo_args.py)."""
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run the model on the CUDA card (default) or the CPU")
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--fea_num_layers", type=int, default=6)
    p.add_argument("--fea_filter_multiplier", type=int, default=8)
    p.add_argument("--fea_block_multiplier", type=int, default=4)
    p.add_argument("--fea_step", type=int, default=3)
    p.add_argument("--mat_num_layers", type=int, default=12)
    p.add_argument("--mat_filter_multiplier", type=int, default=8)
    p.add_argument("--mat_block_multiplier", type=int, default=4)
    p.add_argument("--mat_step", type=int, default=3)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--fast_head", action="store_true", help="serving-mode fused soft-argmin")
    if with_arch_files:
        p.add_argument("--net_arch_fea", type=str, default="", help=".npy network path (feature); empty = shipped best")
        p.add_argument("--cell_arch_fea", type=str, default="")
        p.add_argument("--net_arch_mat", type=str, default="")
        p.add_argument("--cell_arch_mat", type=str, default="")


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", type=str, default="sceneflow", choices=DATASETS)
    p.add_argument("--data_root", type=str, default=None, help="dataset root dir (default: ./dataset/<name>)")
    p.add_argument("--listset", type=str, required=True, help="list-set name under --lists_dir")
    p.add_argument("--lists_dir", type=str, default="dataloaders/lists")
    p.add_argument("--crop_height", type=int, required=True)
    p.add_argument("--crop_width", type=int, required=True)
    p.add_argument("--workers", type=int, default=4)


def train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Retrain / fine-tune a decoded LEAStereo model (reference train.py)")
    add_model_args(p)
    add_data_args(p)
    p.add_argument(
        "--tensorboard", action="store_true",
        help="also write TensorBoard event files next to metrics.jsonl (reference train.py:100-101)",
    )
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--test_batch_size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=2048)
    p.add_argument("--solver", type=str, default="adam", choices=["adam", "sgd"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--milestones", type=int, nargs="*", default=[30, 50, 300])
    p.add_argument("--lr_gamma", type=float, default=0.5)
    p.add_argument("--lr_scheduler", type=str, default="multistep",
                   choices=["multistep", "cos", "poly", "step"],
                   help="reference utils/lr_scheduler.py modes + torch MultiStepLR")
    p.add_argument("--lr_step", type=int, default=0, help="epochs per 0.1x decay ('step' mode)")
    p.add_argument("--warmup_epochs", type=int, default=0, help="linear LR warmup epochs")
    p.add_argument("--min_lr", type=float, default=None, help="LR floor (before warmup scaling)")
    p.add_argument("--shift", type=int, default=0)
    p.add_argument("--left_right", action="store_true")
    p.add_argument("--seed", type=int, default=2019)
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint to resume from: a .pth file, or a checkpoint kind directory "
                   "(its latest epoch); tensors whose name and shape match are adopted")
    p.add_argument("--freeze_feature", type=int, default=0)
    p.add_argument("--freeze_matching", type=int, default=0, help="number of matching cells to freeze")
    p.add_argument("--edge_loss_w", type=float, default=0.0, help="weight of edge-aware loss")
    p.add_argument(
        "--val_other", type=str, action="append", default=None,
        metavar="NAME:DATASET:LIST:ROOT[:ZSHIFT]",
        help="extra fixed-list validation sweep per epoch, repeatable "
        "(reference train.py:243-307 Tagil val12/34/56 sweeps)",
    )
    p.add_argument("--experiment", type=str, default="default")
    p.add_argument("--run_root", type=str, default="run")
    p.add_argument("--patience", type=int, default=1500)
    p.add_argument("--es_delta", type=float, default=0.001)
    p.add_argument("--ckpt_period", type=int, default=20)
    p.add_argument(
        "--loop_mode", type=str, default="early_stop", choices=["early_stop", "n_epochs"],
        help="early_stop: patience/delta loop (reference train.py:367-382, the "
        "default entry). n_epochs: run exactly --epochs epochs, save best on "
        "improvement plus periodic checkpoints every --ckpt_period epochs once "
        "epoch >= --ckpt_min_epoch (reference train.py:393-429 dataset cadence; "
        "sceneflow there saved every epoch -> use --ckpt_period 1)",
    )
    p.add_argument("--ckpt_min_epoch", type=int, default=0,
                   help="first epoch eligible for periodic checkpoints in n_epochs "
                   "mode (reference train.py:405 used 3000 for non-sceneflow)")
    p.add_argument("--max_steps_per_epoch", type=int, default=0, help="truncate epochs (smoke runs)")
    return p


def predict_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batch-free inference over a list file (reference predict.py)")
    add_model_args(p)
    add_data_args(p)
    p.add_argument("--checkpoint", type=str, default="",
                   help="torch state_dict file (.pth; a reference file loads as is); empty: random init")
    p.add_argument("--output_dir", type=str, default="predictions")
    p.add_argument("--split", type=str, default="test", choices=["train", "val", "test"])
    p.add_argument(
        "--save_gt",
        action="store_true",
        help="also render the ground-truth disparity per frame (reference predict.py:273-278)",
    )
    p.add_argument(
        "--full_frame",
        action="store_true",
        help="pad frames larger than the crop up to the next model-valid shape "
        "and predict/evaluate the whole frame (the reference center-crops both "
        "prediction and GT, evaluation.py:288)",
    )
    p.add_argument(
        "--confidence",
        action="store_true",
        help="also emit the per-pixel disparity-entropy confidence map "
        "(reference DispEntropy, models/build_model_2d.py:11-24 — dead code "
        "there; saved as <frame>_conf.{png,npy})",
    )
    return p


def evaluate_parser() -> argparse.ArgumentParser:
    p = predict_parser()
    p.description = "Inference + per-frame metrics and error renders (reference evaluation.py)"
    p.add_argument("--z_shift", type=float, default=0.0)
    p.add_argument("--round_disp", action="store_true", help="round predictions (reference evaluation.py:169)")
    p.add_argument("--thresholds", type=float, nargs="*", default=[1.0, 2.0, 3.0])
    return p
