"""Batch-free inference driver (port of ``leastereo_tpu/cli/predict.py``;
reference ``predict.py``).

Per frame: load + standardize, sentinel-pad or center-crop to the inference
shape, forward on the model's device, un-pad, save a turbo-colormapped PNG
and the ``.npy`` disparity; prints per-frame wall time.

    python -m leastereo_tpu_torch.cli.predict --dataset kitti15_part \
        --listset kitti15_part --crop_height 384 --crop_width 1248

``--checkpoint`` takes a torch state_dict file (``utils/checkpoint.py``),
not an orbax directory.

Parallel (``cli/common.py`` ``run_on_mesh``): ``--mesh_data N`` splits the
frames over N data ranks (rank i takes frames i, i + N, ...);
``--mesh_disp M`` shards each frame's cost volume over M ranks (the CP
analog for maxdisp-408 Middlebury frames, ``models/leastereo.py``), every
one of which ends with the whole map. The first disp rank of each data rank
writes its frames, so every output file is the one-process run's.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..data import ListSet, StereoListDataset
from ..data.loaders import uses_left_disparity
from ..data.transforms import test_transform
from ..parallel import Mesh
from ..utils.checkpoint import load_state_dict_file
from ..utils.colorize import colorize_disparity
from ..utils.tracing import span
from .common import Timer, build_model, run_on_mesh
from .config import predict_parser

__all__ = ["main", "run_frame", "make_forward", "pad_to_valid", "save_frame", "save_confidence"]


def make_forward(model: torch.nn.Module):
    """``fwd(left, right)``: NHWC float32 numpy batches -> the model's fp32
    ``(B, H, W)`` disparity as numpy (a ``(disp, entropy)`` tuple when the
    model returns the entropy), run under ``torch.inference_mode`` on the
    model's device."""
    device = next(model.parameters()).device

    def fwd(left: np.ndarray, right: np.ndarray):
        with span("frame"):
            with torch.inference_mode():
                with span("h2d"):
                    left = torch.from_numpy(np.ascontiguousarray(left, np.float32)).to(device)
                    right = torch.from_numpy(np.ascontiguousarray(right, np.float32)).to(device)
                out = model(left, right)
            with span("d2h"):
                if isinstance(out, tuple):
                    return tuple(o.float().cpu().numpy() for o in out)
                return out.float().cpu().numpy()

    return fwd


def pad_to_valid(h: int, w: int, multiple: int = 12) -> tuple[int, int]:
    """Smallest shape >= (h, w) whose sides are multiples of ``multiple``;
    a model takes every such shape when ``multiple`` is its
    ``size_multiple``."""
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def run_frame(
    fwd,
    stack: np.ndarray,
    crop_height: int,
    crop_width: int,
    use_left: bool = True,
    full_frame: bool = False,
    multiple: int | None = None,
):
    """Pad-or-crop one frame, run the model, un-pad the prediction
    (reference predict.py:144-174).

    ``full_frame=True`` is a capability superset of the reference: frames
    larger than the crop are sentinel-padded up to the next multiple of
    ``multiple``, which it then requires (the model's ``size_multiple``,
    24 for ``BEST_SCENEFLOW``), and evaluated whole instead of
    center-cropped (the reference always center-crops both prediction and
    ground truth, evaluation.py:288).

    A ``fwd`` returning a tuple (e.g. ``(disp, entropy)`` with
    ``--confidence``) yields a tuple of identically un-padded maps.
    """
    _, h, w = stack.shape
    if full_frame:
        if multiple is None:
            raise ValueError("full_frame pads to the model's size_multiple: pass it as multiple")
        crop_height, crop_width = pad_to_valid(max(h, crop_height), max(w, crop_width), multiple)
    with span("transform"):
        left, right, _ = test_transform(stack, crop_height, crop_width, use_left=use_left)
    out = fwd(left[None], right[None])
    is_tuple = isinstance(out, tuple)

    def unpad(x):
        x = np.asarray(x, np.float32)[0]
        if h <= crop_height and w <= crop_width:
            x = x[crop_height - h :, crop_width - w :]
        return x

    return tuple(unpad(o) for o in out) if is_tuple else unpad(out)


def save_confidence(output_dir: str, name: str, entropy: np.ndarray) -> None:
    """``<name>_conf.png`` (entropy over its max, gray) and ``<name>_conf.npy``."""
    from PIL import Image

    gray = (np.clip(entropy / max(entropy.max(), 1e-12), 0, 1) * 255).astype(np.uint8)
    with span("png"):
        Image.fromarray(gray).save(os.path.join(output_dir, f"{name}_conf.png"))
    with span("npy"):
        np.save(os.path.join(output_dir, f"{name}_conf.npy"), entropy)


def save_frame(output_dir: str, name: str, disp: np.ndarray, entropy=None, gt=None, maxdisp: int = 192) -> None:
    """``<name>.png`` (Turbo render) and ``<name>.npy``; the confidence maps
    when ``entropy`` is given; ``<name>_gt.png`` when ``gt`` is."""
    from PIL import Image

    with span("save"):
        if entropy is not None:
            save_confidence(output_dir, name, entropy)
        render = colorize_disparity(disp)
        with span("png"):
            Image.fromarray(render).save(os.path.join(output_dir, f"{name}.png"))
        with span("npy"):
            np.save(os.path.join(output_dir, f"{name}.npy"), disp)
        if gt is not None:
            render = colorize_disparity(gt, vmin=0, vmax=maxdisp)
            with span("png"):
                Image.fromarray(render).save(os.path.join(output_dir, f"{name}_gt.png"))


def main(argv=None) -> int:
    args = predict_parser().parse_args(argv)
    return run_on_mesh("leastereo_tpu_torch.cli.predict", argv, args, lambda mesh: predict(args, mesh))


def predict(args, mesh: Mesh) -> int:
    """Predict this rank's frames of the ``args`` run on ``mesh``."""
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
    multiple = model.size_multiple if args.full_frame else None
    for i in range(mesh.data_index, len(ds), mesh.data):
        stack = ds.load_stack(i)
        with Timer() as t:
            disp = run_frame(fwd, stack, args.crop_height, args.crop_width, use_left, args.full_frame, multiple)
        entropy = None
        if isinstance(disp, tuple):
            disp, entropy = disp
        if not writer:
            continue
        name = ds.entries[i].replace("/", "_")
        gt = (stack[6] if use_left else stack[7]) if args.save_gt else None
        save_frame(args.output_dir, name, disp, entropy, gt, args.maxdisp)
        print(f"{ds.entries[i]}: {t.seconds:.3f}s  disp[{disp.min():.1f}, {disp.max():.1f}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
