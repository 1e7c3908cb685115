"""argparse configuration for the port's CLI drivers.

The flags, names and defaults of ``leastereo_tpu/cli/config.py`` (reference
``config_utils/*.py``), except that ``--platform {cpu,tpu}`` becomes
``--device {cuda,cpu}`` (default ``cuda``). The mesh flags wait for the
port's parallel runs.
"""

from __future__ import annotations

import argparse

__all__ = ["add_model_args", "add_data_args", "predict_parser", "evaluate_parser"]

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
