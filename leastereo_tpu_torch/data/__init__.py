"""The port's data readers: PFM, per-dataset loaders, transforms and list-file
datasets (copies of the numpy-only modules of ``leastereo_tpu/data``)."""

from .dataset import ListSet, StereoListDataset, StereoSample, default_root
from .loaders import LOADERS, uses_left_disparity
from .pfm import read_pfm, write_pfm
from .transforms import (
    PAD_DISP_SENTINEL,
    standardize_stack,
    test_transform,
    train_transform,
)

__all__ = [
    "ListSet",
    "StereoListDataset",
    "StereoSample",
    "default_root",
    "LOADERS",
    "uses_left_disparity",
    "read_pfm",
    "write_pfm",
    "PAD_DISP_SENTINEL",
    "standardize_stack",
    "test_transform",
    "train_transform",
]
