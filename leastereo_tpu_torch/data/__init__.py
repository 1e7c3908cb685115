"""The port's data path: PFM, per-dataset loaders (with the native PNG/PFM
reader of ``native.py``), transforms, list-file datasets, the offline
augmentation, demo-data, list and dataset tools (copies of the numpy-only
modules of ``leastereo_tpu/data``), and the batch pipeline to the device
(``pipeline.py``)."""

from .augment import (
    new_tagil_pipeline,
    run_new_tagil_aug,
    run_satellite_aug,
    satellite_pipeline,
)
from .dataset import ListSet, StereoListDataset, StereoSample, default_root
from .lists import build_satellite_lists, build_sceneflow_lists, build_whu_lists, write_list
from .loaders import LOADERS, uses_left_disparity
from .pfm import read_pfm, write_pfm
from .pipeline import batch_iterator, make_loader, prefetch_to_device
from .tools import aggregate_metrics, clean_new_tagil, convert_whu, tagil_sample_valid
from .transforms import (
    PAD_DISP_SENTINEL,
    standardize_stack,
    test_transform,
    train_transform,
)

__all__ = [
    "new_tagil_pipeline",
    "run_new_tagil_aug",
    "run_satellite_aug",
    "satellite_pipeline",
    "write_list",
    "aggregate_metrics",
    "clean_new_tagil",
    "convert_whu",
    "tagil_sample_valid",
    "ListSet",
    "StereoListDataset",
    "StereoSample",
    "default_root",
    "build_satellite_lists",
    "build_sceneflow_lists",
    "build_whu_lists",
    "LOADERS",
    "uses_left_disparity",
    "read_pfm",
    "write_pfm",
    "batch_iterator",
    "make_loader",
    "prefetch_to_device",
    "PAD_DISP_SENTINEL",
    "standardize_stack",
    "test_transform",
    "train_transform",
]
