"""Offline list builders: scan a dataset tree and emit split ``.list`` files.

Replaces ``dataloaders/build_lists/{sceneflow,satellite,whu}.py``. All
builders write the five-file list-set layout consumed by
:class:`~leastereo_tpu_torch.data.dataset.ListSet` and take an explicit seed.

A copy of ``leastereo_tpu/data/lists.py``, held to it by
``tests/test_torch_data_tools.py``.
"""

from __future__ import annotations

import os
import re

import numpy as np

__all__ = ["build_sceneflow_lists", "build_satellite_lists", "build_whu_lists", "write_list"]

_LIST_NAMES = ("search_arch", "search_weights", "train", "val", "test")


def write_list(lists_dir: str, name: str, entries) -> None:
    os.makedirs(lists_dir, exist_ok=True)
    with open(os.path.join(lists_dir, f"{name}.list"), "w") as f:
        f.writelines(e + "\n" for e in entries)


def _collect_left_images(root: str, folder: str) -> list[str]:
    out = []
    base = os.path.join(root, folder)
    for scene in sorted(next(os.walk(base))[1]):
        left_dir = os.path.join(base, scene, "left")
        for img in sorted(next(os.walk(left_dir))[2]):
            out.append(os.path.join(folder, scene, "left", img))
    return out


def build_sceneflow_lists(dataset_dir: str, lists_dir: str, seed: int = 0) -> None:
    """TRAIN/A-C split 1/3 each into search_arch / search_weights / train;
    TEST/A-C split half into val / test (reference build_lists/sceneflow.py)."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for sub in "ABC":
        train += _collect_left_images(dataset_dir, os.path.join("frames_finalpass", "TRAIN", sub))
        test += _collect_left_images(dataset_dir, os.path.join("frames_finalpass", "TEST", sub))
    rng.shuffle(train)
    rng.shuffle(test)
    n = len(train)
    write_list(lists_dir, "search_arch", train[: n // 3])
    write_list(lists_dir, "search_weights", train[n // 3 : 2 * n // 3])
    write_list(lists_dir, "train", train[2 * n // 3 :])
    m = len(test)
    write_list(lists_dir, "val", test[: m // 2])
    write_list(lists_dir, "test", test[m // 2 :])


def build_satellite_lists(
    dataset_dir: str,
    lists_dir: str,
    seed: int = 0,
    fractions: tuple[float, float, float, float] = (0.3, 0.3, 0.2, 0.1),
) -> None:
    """Per-sample directories split 30/30/20/10/10% into the five lists
    (reference build_lists/satellite.py)."""
    rng = np.random.default_rng(seed)
    names = sorted(d for d in next(os.walk(dataset_dir))[1] if not d.startswith("."))
    rng.shuffle(names)
    n = len(names)
    start = 0
    for list_name, frac in zip(_LIST_NAMES[:4], fractions):
        end = start + int(n * frac)
        write_list(lists_dir, list_name, names[start:end])
        start = end
    write_list(lists_dir, "test", names[start:])


_WHU_SAMPLE_RE = re.compile(r"([A-Z]+)_left_(\d+)\.tiff")


def build_whu_lists(dataset_dir: str, lists_dir: str) -> None:
    """train/val/test subdirectories; sample names parsed from
    ``<PFX>_left_<n>.tiff`` (reference build_lists/whu.py)."""
    write_list(lists_dir, "search_arch", [])
    write_list(lists_dir, "search_weights", [])
    for split in ("train", "val", "test"):
        left_dir = os.path.join(dataset_dir, split, "left")
        names = []
        for fn in sorted(next(os.walk(left_dir))[2]):
            m = _WHU_SAMPLE_RE.search(fn)
            if m:
                names.append(f"{m.group(1)}_{m.group(2)}")
        write_list(lists_dir, split, names)
