"""The port's offline data tools and native reader
(``leastereo_tpu_torch/data/{augment,demo,lists,tools,native}.py``) against
the JAX package's twins, on the CPU.

The four tool modules are copies: on the same seeded ``np.random.Generator``
and inputs they must give equal arrays and byte-equal files, the reference's
two quirks included (``shift_sample`` shifts the invalid zeros of sparse
ground truth; ``sparsify_disparity`` lets uint16 values wrap). The native
PNG/PFM reader is held to the JAX package's Python reader on the bundled
``dataset/sceneflow_part`` frames: disparities equal, standardised channels
within 1e-5 (it sums the mean and std in another order).
"""

import os
import pathlib

import numpy as np
import pytest

from leastereo_tpu.data import augment as jax_augment
from leastereo_tpu.data import demo as jax_demo
from leastereo_tpu.data import lists as jax_lists
from leastereo_tpu.data import tools as jax_tools
from leastereo_tpu_torch.data import augment, demo, lists, loaders, native, tools
from test_data import _make_sceneflow_tree

REPO = pathlib.Path(__file__).resolve().parents[1]
SCENEFLOW_PART = REPO / "dataset" / "sceneflow_part"
STD_TOL = 1e-5


def _assert_samples_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


def _tagil_sample(h=60, w=90, seed=0):
    rng = np.random.RandomState(seed)
    s = {"name": "s0", "left": rng.rand(h, w).astype(np.float32) * 255, "right": rng.rand(h, w).astype(np.float32) * 255}
    for k in ("displ", "dispr", "disp0l", "disp0r"):
        d = (rng.rand(h, w) * 10 + 5).astype(np.float32)
        d[rng.rand(h, w) < 0.1] = np.nan
        s[k] = d
    return s


def _satellite_sample(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "name": "x",
        "left": rng.randint(0, 255, (40, 60, 3)).astype(np.uint8),
        "right": rng.randint(0, 255, (40, 60, 3)).astype(np.uint8),
        "displ": rng.randint(0, 50, (40, 60)).astype(np.uint8),
        "dispr": rng.randint(0, 50, (40, 60)).astype(np.uint8),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_new_tagil_pipeline_matches_jax(seed):
    samples = [_tagil_sample(seed=seed), _tagil_sample(seed=seed + 10)]
    got = list(augment.new_tagil_pipeline(samples, np.random.default_rng(seed), crop_hw=(16, 24), n_crops=4))
    want = list(jax_augment.new_tagil_pipeline(samples, np.random.default_rng(seed), crop_hw=(16, 24), n_crops=4))
    _assert_samples_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_satellite_pipeline_matches_jax(seed):
    samples = [_satellite_sample(seed)]
    got = list(augment.satellite_pipeline(samples, np.random.default_rng(seed), crop_hw=(16, 24), n_iter=5))
    want = list(jax_augment.satellite_pipeline(samples, np.random.default_rng(seed), crop_hw=(16, 24), n_iter=5))
    _assert_samples_equal(got, want)


def test_forward_warp_right_matches_jax():
    rng = np.random.default_rng(4)
    image = rng.random((20, 30)).astype(np.float32)
    disp = (rng.random((20, 30)) * 8).astype(np.float32)
    got = augment.forward_warp_right(image, disp)
    np.testing.assert_array_equal(got, jax_augment.forward_warp_right(image, disp))


def test_shift_sample_quirk_shifts_invalid_zeros():
    """Pinned as the reference behaves: sparse ground truth's invalid zeros
    become the shift value (ROADMAP.md §C)."""
    s = _tagil_sample(20, 30)
    s["displ"][:, :10] = 0.0
    got, want = augment.shift_sample(s, 4), jax_augment.shift_sample(s, 4)
    _assert_samples_equal([got], [want])
    assert (got["displ"][:, :10] == 4.0).all()


def test_render_and_sparsify_match_jax():
    got = demo.render_stereo_scene(123, 48, 80, 32)
    want = jax_demo.render_stereo_scene(123, 48, 80, 32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    sparse = demo.sparsify_disparity(got[2], np.random.default_rng(5))
    np.testing.assert_array_equal(sparse, jax_demo.sparsify_disparity(want[2], np.random.default_rng(5)))
    assert sparse.dtype == np.uint16


def test_sparsify_quirk_wraps_uint16():
    """Pinned as the reference behaves: round(d * 256) >= 65536 wraps
    (ROADMAP.md §C); 300 px becomes 76800 - 65536 = 11264."""
    disp = np.full((9, 4), 300.0, np.float32)
    got = demo.sparsify_disparity(disp, np.random.default_rng(0))
    np.testing.assert_array_equal(got, jax_demo.sparsify_disparity(disp, np.random.default_rng(0)))
    assert set(np.unique(got)) <= {0, 11264} and (got == 11264).any()


def _tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_generate_kitti_demo_dataset_byte_equal(tmp_path):
    got = demo.generate_kitti_demo_dataset(str(tmp_path / "port"), num_pairs=2, height=48, width=96, seed=7)
    want = jax_demo.generate_kitti_demo_dataset(str(tmp_path / "jax"), num_pairs=2, height=48, width=96, seed=7)
    assert got == want
    files = _tree_bytes(tmp_path / "port")
    assert len(files) == 6 and files == _tree_bytes(tmp_path / "jax")


def test_generate_demo_dataset_byte_equal(tmp_path):
    got = demo.generate_demo_dataset(str(tmp_path / "port"), num_pairs=2, height=48, width=96, seed=3)
    want = jax_demo.generate_demo_dataset(str(tmp_path / "jax"), num_pairs=2, height=48, width=96, seed=3)
    assert got == want
    files = _tree_bytes(tmp_path / "port")
    assert len(files) == 8 and files == _tree_bytes(tmp_path / "jax")


def test_build_lists_match_jax(tmp_path):
    sf = tmp_path / "sf"
    for split in ("TRAIN", "TEST"):
        for sub in "ABC":
            _make_sceneflow_tree(sf, scenes=(f"{split}/{sub}/0001",), names=("0001", "0002", "0003"))
    sat = tmp_path / "sat"
    for i in range(10):
        (sat / f"s{i:02d}").mkdir(parents=True)
    whu = tmp_path / "whu"
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        (whu / split / "left").mkdir(parents=True)
        for i in range(n):
            (whu / split / "left" / f"KM_left_{i}.tiff").write_bytes(b"x")
        (whu / split / "left" / "notes.txt").write_bytes(b"x")
    for seed in (0, 3):
        for pkg, out in ((lists, tmp_path / "port"), (jax_lists, tmp_path / "jax")):
            pkg.build_sceneflow_lists(str(sf), str(out / "sf"), seed=seed)
            pkg.build_satellite_lists(str(sat), str(out / "sat"), seed=seed)
            pkg.build_whu_lists(str(whu), str(out / "whu"))
        files = _tree_bytes(tmp_path / "port")
        assert len(files) == 15 and files == _tree_bytes(tmp_path / "jax")


def test_aggregate_metrics_matches_jax(tmp_path):
    for i, epe in enumerate([1.0, 3.0, 0.5]):
        (tmp_path / f"s{i}_metrics.txt").write_text(f"epe: {epe}\nbad3: {0.1 * (i + 1)}\nnote\n")
    (tmp_path / "other.txt").write_text("epe: 100\n")
    got = tools.aggregate_metrics(str(tmp_path))
    assert got == jax_tools.aggregate_metrics(str(tmp_path))
    assert got["epe"] == 1.5
    assert tools.aggregate_metrics(str(tmp_path / "s0_metrics.txt").replace("s0_metrics.txt", "")) == got


def _tagil_dir(root, seed, zeros=0.0, nan=0.0, high=0.0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for fn in ("img_L.tif", "img_R.tif"):
        img = rng.randint(1, 400, (16, 16)).astype(np.uint16)
        img[rng.rand(16, 16) < zeros] = 0
        img[rng.rand(16, 16) < high] = 900
        Image.fromarray(img).save(root / fn)
    for fn in ("disp_L_lidar.tif", "disp_R_lidar.tif"):
        d = rng.rand(16, 16).astype(np.float32) * 40
        d[rng.rand(16, 16) < nan] = np.nan
        Image.fromarray(d).save(root / fn)
    return str(root)


@pytest.mark.parametrize("case,kwargs,valid", [
    ("good", {}, True),
    ("dark", {"zeros": 0.4}, False),
    ("bright", {"high": 0.3}, False),
    ("occluded", {"nan": 0.8}, False),
])
def test_tagil_sample_valid_matches_jax(tmp_path, case, kwargs, valid):
    d = _tagil_dir(tmp_path / case, seed=len(case), **kwargs)
    assert tools.tagil_sample_valid(d) == jax_tools.tagil_sample_valid(d) == valid


def _sceneflow_part_paths(name):
    base = SCENEFLOW_PART / "frames_finalpass" / "35mm_forward_fast"
    dbase = SCENEFLOW_PART / "disparity" / "35mm_forward_fast"
    return [str(base / "left" / f"{name}.png"), str(base / "right" / f"{name}.png"),
            str(dbase / "left" / f"{name}.pfm"), str(dbase / "right" / f"{name}.pfm")]


SCENEFLOW_PART_FRAMES = sorted(os.path.splitext(f)[0] for f in os.listdir(
    SCENEFLOW_PART / "frames_finalpass" / "35mm_forward_fast" / "left"))


@pytest.mark.parametrize("name", SCENEFLOW_PART_FRAMES)
def test_native_reader_matches_jax_python_reader(name):
    """The port's native reader (built here with g++ and libpng) against the
    JAX package's PIL + PFM path on the bundled SceneFlow frames."""
    from leastereo_tpu.data.loaders import _finish, _open_image
    from leastereo_tpu.data.pfm import read_pfm
    from leastereo_tpu.data.transforms import standardize_stack

    if not native.native_available():
        pytest.skip(f"native reader cannot be built here: {native._missing}")
    paths = _sceneflow_part_paths(name)
    got = native.load_stereo_sample_native(*paths)
    want = _finish(standardize_stack(_open_image(paths[0]), _open_image(paths[1])),
                   read_pfm(paths[2]), read_pfm(paths[3]))
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got[6:], want[6:])
    np.testing.assert_allclose(got[:6], want[:6], rtol=0, atol=STD_TOL)
    np.testing.assert_array_equal(native.read_pfm_native(paths[2]), read_pfm(paths[2]))
    # The port's loader takes the native reader when it is built.
    np.testing.assert_array_equal(loaders.load_sceneflow_legacy(str(SCENEFLOW_PART), name), got)


def test_native_reader_that_does_not_load_leaves_pil(monkeypatch, caplog):
    """A built library that the loader cannot open (its libpng missing at
    run time) leaves the PIL path, with the reason logged."""
    def cannot_open(*args, **kwargs):
        raise OSError("libpng16.so.16: cannot open shared object file")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_missing", None)
    monkeypatch.setattr(native, "_build", lambda: None)
    monkeypatch.setattr(native, "_toolchain_missing", lambda: None)
    monkeypatch.setattr(native.ctypes, "CDLL", cannot_open)
    with caplog.at_level("WARNING", logger=native.__name__):
        assert not native.native_available()
    assert "does not load" in native._missing and "libpng16.so.16" in caplog.text
    name = SCENEFLOW_PART_FRAMES[0]
    got = loaders.load_sceneflow_legacy(str(SCENEFLOW_PART), name)
    assert got.shape[0] == 8 and np.isfinite(got).all()
