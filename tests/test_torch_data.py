"""The port's data readers (leastereo_tpu_torch/data, utils/colorize.py)
against the JAX package's, on the bundled KITTI frames and a synthetic
SceneFlow tree.

Disparity channels must be equal. Standardised channels agree within 1e-5:
the JAX loader may decode a PNG/PFM pair with its native C++ reader, whose
mean and std sum in another order. Transforms and the Turbo render are the
same numpy code on both sides, so their outputs must be equal.
"""

import os
import pathlib

import numpy as np
import pytest

from leastereo_tpu.data import loaders as jax_loaders
from leastereo_tpu.data import transforms as jax_transforms
from leastereo_tpu.data.dataset import StereoListDataset as JaxDataset
from leastereo_tpu.utils.colorize import colorize_disparity as jax_colorize
from leastereo_tpu_torch.data import (
    ListSet,
    StereoListDataset,
    loaders,
    pfm,
    transforms,
)
from leastereo_tpu_torch.utils.colorize import colorize_disparity
from test_data import _make_sceneflow_tree

REPO = pathlib.Path(__file__).resolve().parents[1]
KITTI_ROOT = str(REPO / "dataset" / "kitti15_part")
KITTI_FRAMES = sorted(os.listdir(REPO / "dataset" / "kitti15_part" / "image_2"))
STD_TOL = 1e-5


def _assert_stacks_match(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got[6:], ref[6:])
    np.testing.assert_allclose(got[:6], ref[:6], rtol=0, atol=STD_TOL)


@pytest.mark.parametrize("frame", KITTI_FRAMES)
def test_load_kitti2015_matches_jax(frame):
    rel = f"image_2/{frame}"
    got = loaders.load_kitti2015(KITTI_ROOT, rel)
    _assert_stacks_match(got, jax_loaders.load_kitti2015(KITTI_ROOT, rel))
    assert got.shape == (8, 324, 576)
    # Sparse lidar ground truth: zero is invalid, the rest is uint16 / 256.
    assert (got[6] == 0).any() and (got[6] > 1).any()
    assert (got[7] == 2 * 576).all()


@pytest.fixture(scope="module")
def sceneflow_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sf")
    return root, _make_sceneflow_tree(root, scenes=("TRAIN/A/0001", "TRAIN/B/0002"))


def test_load_sceneflow_matches_jax(sceneflow_tree):
    root, rels = sceneflow_tree
    for rel in rels:
        _assert_stacks_match(loaders.load_sceneflow(str(root), rel), jax_loaders.load_sceneflow(str(root), rel))


def test_pfm_round_trip_across_packages(tmp_path):
    from leastereo_tpu.data.pfm import read_pfm as jax_read_pfm
    from leastereo_tpu.data.pfm import write_pfm as jax_write_pfm

    rng = np.random.RandomState(3)
    for shape in ((7, 5), (4, 6, 3)):
        a = rng.randn(*shape).astype(np.float32)
        pfm.write_pfm(tmp_path / "port.pfm", a)
        jax_write_pfm(tmp_path / "jax.pfm", a)
        assert (tmp_path / "port.pfm").read_bytes() == (tmp_path / "jax.pfm").read_bytes()
        np.testing.assert_array_equal(pfm.read_pfm(tmp_path / "jax.pfm"), a)
        np.testing.assert_array_equal(jax_read_pfm(tmp_path / "port.pfm"), a)


def _kitti_stack():
    return loaders.load_kitti2015(KITTI_ROOT, f"image_2/{KITTI_FRAMES[0]}")


@pytest.mark.parametrize("crop", [(384, 1248), (96, 192), (300, 600), (324, 576)])
@pytest.mark.parametrize("use_left", [True, False])
def test_test_transform_matches_jax(crop, use_left):
    stack = _kitti_stack()
    got = transforms.test_transform(stack, *crop, use_left=use_left)
    ref = jax_transforms.test_transform(stack, *crop, use_left=use_left)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if crop == (384, 1248):
        # Sentinel pad, content bottom-right (reference common.py:47-57).
        assert (got[2][:60] == jax_transforms.PAD_DISP_SENTINEL).all() == use_left


@pytest.mark.parametrize(
    "crop,kw",
    [
        ((96, 192), {}),
        ((96, 192), {"shift": 4}),
        ((96, 192), {"use_left": False, "left_right": True}),
        ((384, 1248), {}),
        ((384, 600), {"shift": 2}),
        ((300, 240), {}),
    ],
)
def test_train_transform_matches_jax(crop, kw):
    stack = _kitti_stack()
    for seed in range(3):
        got = transforms.train_transform(stack, *crop, np.random.default_rng(seed), **kw)
        ref = jax_transforms.train_transform(stack, *crop, np.random.default_rng(seed), **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_datasets_match_jax():
    lists = ListSet.resolve("kitti15_part", str(REPO / "dataloaders" / "lists"))
    for training in (False, True):
        kw = dict(root=KITTI_ROOT, crop_size=(96, 192), training=training, shift=2, seed=5)
        port = StereoListDataset("kitti15_part", lists.train, **kw)
        ref = JaxDataset("kitti15_part", lists.train, **kw)
        assert port.entries == ref.entries and len(port) == 4
        for i in range(len(port)):
            got, want = port.__getitem__(i, epoch=1), ref.__getitem__(i, epoch=1)
            np.testing.assert_array_equal(got.disparity, want.disparity)
            np.testing.assert_allclose(got.left, want.left, rtol=0, atol=STD_TOL)


@pytest.mark.parametrize("kw", [{}, {"vmin": 0, "vmax": 48}, {"vmin": 5.0, "vmax": 5.0}])
def test_colorize_byte_equal(kw):
    rng = np.random.RandomState(1)
    disp = (rng.rand(37, 53) * 60).astype(np.float32)
    disp[0, :4] = (np.nan, np.inf, -np.inf, -3.0)
    got = colorize_disparity(disp, **kw)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    assert got.tobytes() == jax_colorize(disp, **kw).tobytes()


def test_loaders_table_matches_jax():
    assert set(loaders.LOADERS) == set(jax_loaders.LOADERS)
    for name, fn in loaders.LOADERS.items():
        assert fn.__name__ == jax_loaders.LOADERS[name].__name__
        assert loaders.uses_left_disparity(name) == jax_loaders.uses_left_disparity(name)
