"""List-file stereo datasets + list-set resolution.

Replaces the reference's ``DatasetFromList`` (dataloaders/datasets/stereo.py:124)
and ``ListsSet`` (dataloaders/make_data_loaders.py:8-25). Dataset roots are
explicit configuration, not a hardcoded registry (reference ``mypath.py``),
with the same default layout available via :func:`default_root`.

A copy of ``leastereo_tpu/data/dataset.py`` (numpy only).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.tracing import span
from .loaders import LOADERS, uses_left_disparity
from .transforms import test_transform, train_transform

__all__ = ["ListSet", "StereoSample", "StereoListDataset", "default_root"]

_DEFAULT_ROOTS = {
    "sceneflow": "dataset/sceneflow/",
    "kitti15": "dataset/kitti2015/training/",
    "kitti15_part": "dataset/kitti15_part/",
    "kitti12": "dataset/kitti2012/training/",
    "middlebury": "dataset/MiddEval3/trainingH/",
    "sceneflow_part": "dataset/sceneflow_part/",
    "satellite": "dataset/old_tagil/",
    "dfc2019": "dataset/dfc2019/",
    "new_tagil": "dataset/new_tagil/",
    "whu": "dataset/whu/",
    "whu2new_tagil": "dataset/new_tagil/",
}


def default_root(dataset: str, base: str = ".") -> str:
    """Default on-disk location for a dataset (reference mypath.py:3-24)."""
    try:
        return os.path.join(base, _DEFAULT_ROOTS[dataset])
    except KeyError:
        raise KeyError(f"dataset {dataset!r} not available") from None


@dataclass(frozen=True)
class ListSet:
    """The five split lists of one experiment list-set
    (reference make_data_loaders.py:8-25)."""

    search_weights: str
    search_arch: str
    train: str
    val: str
    test: str

    @classmethod
    def resolve(cls, name: str, lists_dir: str = "dataloaders/lists") -> "ListSet":
        prefix = os.path.join(lists_dir, name)
        return cls(
            search_weights=os.path.join(prefix, "search_weights.list"),
            search_arch=os.path.join(prefix, "search_arch.list"),
            train=os.path.join(prefix, "train.list"),
            val=os.path.join(prefix, "val.list"),
            test=os.path.join(prefix, "test.list"),
        )


@dataclass
class StereoSample:
    left: np.ndarray  # (H, W, 3) float32, standardized
    right: np.ndarray  # (H, W, 3) float32, standardized
    disparity: np.ndarray  # (H, W) float32


@dataclass
class StereoListDataset:
    """Samples named by a list file, loaded + transformed on the host.

    ``__getitem__`` is a pure function of ``(index, epoch, seed)`` — worker
    processes/threads can load any element independently and two runs with the
    same seed see identical augmentations (the reference's global-``random``
    transforms are irreproducible across worker schedules).
    """

    dataset: str
    list_file: str
    root: str | None = None
    crop_size: tuple[int, int] = (256, 256)
    training: bool = True
    left_right: bool = False
    shift: int = 0
    seed: int = 0
    entries: list = field(init=False)

    def __post_init__(self):
        if self.dataset not in LOADERS:
            raise KeyError(f"unknown dataset {self.dataset!r}; have {sorted(LOADERS)}")
        if self.root is None:
            self.root = default_root(self.dataset)
        with open(self.list_file) as f:
            self.entries = [line.strip() for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.entries)

    def load_stack(self, index: int) -> np.ndarray:
        with span("load"):
            return LOADERS[self.dataset](self.root, self.entries[index])

    def __getitem__(self, index: int, epoch: int = 0) -> StereoSample:
        stack = self.load_stack(index)
        use_left = uses_left_disparity(self.dataset)
        ch, cw = self.crop_size
        if self.training:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, index])
            )
            left, right, disp = train_transform(
                stack, ch, cw, rng,
                use_left=use_left, left_right=self.left_right, shift=self.shift,
            )
        else:
            left, right, disp = test_transform(stack, ch, cw, use_left=use_left)
        return StereoSample(left, right, disp)
