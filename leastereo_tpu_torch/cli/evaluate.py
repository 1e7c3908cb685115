"""Evaluation driver (port of ``leastereo_tpu/cli/evaluate.py``; reference
``evaluation.py``): per-frame inference + EPE / 3px / bad-N metrics,
prediction + GT renders, red error overlays, ``_metrics.txt`` files, and
dataset averages.

    python -m leastereo_tpu_torch.cli.evaluate --dataset kitti15_part \
        --listset kitti15_part --split train --crop_height 384 --crop_width 1248

The mesh flags split the frames and shard the volume as in
``cli/predict.py``; each frame's metrics are all-reduced to rank 0, which
prints the averages of the one-process run.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..data import ListSet, StereoListDataset
from ..data.loaders import uses_left_disparity
from ..parallel import Mesh, all_reduce
from ..utils.checkpoint import load_state_dict_file
from ..utils.colorize import colorize_disparity
from .common import build_model, run_on_mesh
from .config import evaluate_parser
from .predict import make_forward, run_frame, save_confidence

__all__ = ["main", "frame_metrics", "error_overlay", "save_frame"]


def _validity(target: np.ndarray, maxdisp: int) -> np.ndarray:
    return (target > 0.001) & (target < maxdisp)


def frame_metrics(pred: np.ndarray, target: np.ndarray, maxdisp: int, thresholds) -> dict:
    """EPE, 3px-error (>=3px AND >=5% of GT), bad-N fractions
    (reference utils/metrics.py)."""
    mask = _validity(target, maxdisp)
    n = max(int(mask.sum()), 1)
    diff = np.abs(pred - target)
    out = {"epe": float((diff * mask).sum() / n)}
    correct3 = ((diff < 3) | (diff < target * 0.05)) & mask
    out["err3"] = 1.0 - float(correct3.sum()) / n
    for t in thresholds:
        out[f"bad{t:g}"] = 1.0 - float(((diff <= t) & mask).sum()) / n
    out["valid_px"] = int(mask.sum())
    return out


def error_overlay(left_rgb: np.ndarray, pred: np.ndarray, target: np.ndarray, maxdisp: int, threshold: float = 3.0) -> np.ndarray:
    """Grayscale view with wrong pixels painted red
    (reference evaluation.py:134-146)."""
    img = left_rgb.astype(np.float32)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
    gray = (img.mean(axis=-1) * 255).astype(np.uint8)
    out = np.stack([gray, gray, gray], axis=-1)
    mask = _validity(target, maxdisp)
    diff = np.abs(pred - target)
    wrong = mask & (diff >= threshold) & (diff >= target * 0.05)
    out[wrong] = (255, 0, 0)
    return out


def save_frame(
    output_dir: str, name: str, disp: np.ndarray, target: np.ndarray, left: np.ndarray,
    maxdisp: int, metrics: dict, entropy=None,
) -> None:
    """The frame's ``_pred``, ``_gt`` and ``_err`` renders, ``_pred.npy``,
    the confidence maps when ``entropy`` is given, and ``_metrics.txt``."""
    from PIL import Image

    Image.fromarray(colorize_disparity(disp)).save(os.path.join(output_dir, f"{name}_pred.png"))
    Image.fromarray(colorize_disparity(np.where(_validity(target, maxdisp), target, 0))).save(
        os.path.join(output_dir, f"{name}_gt.png")
    )
    Image.fromarray(error_overlay(left, disp, target, maxdisp)).save(
        os.path.join(output_dir, f"{name}_err.png")
    )
    np.save(os.path.join(output_dir, f"{name}_pred.npy"), disp)
    if entropy is not None:
        save_confidence(output_dir, name, entropy)
    with open(os.path.join(output_dir, f"{name}_metrics.txt"), "w") as f:
        for k, v in metrics.items():
            f.write(f"{k}: {v}\n")


def main(argv=None) -> int:
    args = evaluate_parser().parse_args(argv)
    return run_on_mesh("leastereo_tpu_torch.cli.evaluate", argv, args, lambda mesh: evaluate(args, mesh))


def evaluate(args, mesh: Mesh) -> int:
    """Evaluate this rank's frames of the ``args`` run on ``mesh``."""
    lists = ListSet.resolve(args.listset, args.lists_dir)
    ds = StereoListDataset(
        dataset=args.dataset,
        list_file=getattr(lists, args.split),
        root=args.data_root,
        crop_size=(args.crop_height, args.crop_width),
        training=False,
    )

    model = build_model(args, mesh=mesh)
    writer = mesh.disp_index == 0
    if args.checkpoint:
        load_state_dict_file(args.checkpoint, model)
        if mesh.rank == 0:
            print(f"loaded checkpoint {args.checkpoint}", flush=True)
    fwd = make_forward(model)

    os.makedirs(args.output_dir, exist_ok=True)
    use_left = uses_left_disparity(args.dataset)
    keys = ["epe", "err3", *(f"bad{t:g}" for t in args.thresholds), "valid_px"]
    # One row per frame, filled by the writer that evaluated it.
    table = torch.zeros(len(ds), len(keys), dtype=torch.float64, device=next(model.parameters()).device)
    multiple = model.size_multiple if args.full_frame else None
    for i in range(mesh.data_index, len(ds), mesh.data):
        stack = ds.load_stack(i)
        disp = run_frame(fwd, stack, args.crop_height, args.crop_width, use_left, args.full_frame, multiple)
        entropy = None
        if isinstance(disp, tuple):
            disp, entropy = disp
        if args.round_disp:
            disp = np.round(disp)  # reference evaluation.py:169
        disp = disp + args.z_shift
        target = stack[6] if use_left else stack[7]
        # Metrics on the overlap: with --full_frame the prediction covers the
        # whole frame; otherwise it may be a center crop, and the GT is
        # center-cropped to match (parity with reference evaluation.py:288).
        th, tw = disp.shape
        oh = (target.shape[0] - th) // 2 if target.shape[0] > th else 0
        ow = (target.shape[1] - tw) // 2 if target.shape[1] > tw else 0
        target_c = target[oh : oh + th, ow : ow + tw]
        left_c = np.transpose(stack[0:3], (1, 2, 0))[oh : oh + th, ow : ow + tw]

        m = frame_metrics(disp, target_c, args.maxdisp, args.thresholds)
        if not writer:
            continue
        table[i] = torch.tensor([m[k] for k in keys], dtype=torch.float64)
        name = ds.entries[i].replace("/", "_")
        save_frame(args.output_dir, name, disp, target_c, left_c, args.maxdisp, m, entropy)
        print(f"{ds.entries[i]}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items() if k != "valid_px"), flush=True)

    if mesh.data * mesh.disp > 1:
        all_reduce(table, torch.distributed.group.WORLD)
    if len(ds) and mesh.rank == 0:
        print("=== averages ===")
        rows = table.cpu().numpy()
        for j, k in enumerate(keys[:-1]):
            print(f"{k}: {np.mean(rows[:, j]):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
