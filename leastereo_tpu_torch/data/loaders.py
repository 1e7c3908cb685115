"""Per-dataset sample loaders.

Each loader reads one stereo sample from disk and returns the 8-channel
standardized stack described in :mod:`.transforms`. Loader semantics mirror
the reference dataset readers (``dataloaders/datasets/*.py``) including their
occlusion sentinels and coordinate conventions; see each docstring.

A copy of ``leastereo_tpu/data/loaders.py`` (numpy + PIL, and the native
PNG/PFM reader of ``data/native.py``), held to it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.tracing import span
from .pfm import read_pfm
from .transforms import standardize_stack

__all__ = [
    "load_sceneflow",
    "load_sceneflow_legacy",
    "load_dfc2019",
    "load_satellite",
    "load_new_tagil",
    "load_whu",
    "load_whu2new_tagil",
    "load_kitti2015",
    "load_kitti2012",
    "load_middlebury",
    "LOADERS",
    "uses_left_disparity",
]


def _open_image(path) -> np.ndarray:
    from PIL import Image

    with span("decode"):
        return np.asarray(Image.open(path))


def _finish(stack: np.ndarray, disp_left, disp_right) -> np.ndarray:
    stack[6] = disp_left
    stack[7] = disp_right
    return stack


def _load_png_pfm_pair(left_png, right_png, disp_l_pfm, disp_r_pfm) -> np.ndarray:
    """PNG pair + PFM disparities -> 8-channel stack. Uses the native C++
    decoder (data/native.py) when it builds; PIL and :func:`read_pfm` where
    ``g++`` or ``png.h`` is absent."""
    from .native import load_stereo_sample_native, native_available

    if native_available():
        with span("decode"):
            return load_stereo_sample_native(left_png, right_png, disp_l_pfm, disp_r_pfm)
    left = _open_image(left_png)
    right = _open_image(right_png)
    return _finish(standardize_stack(left, right), read_pfm(disp_l_pfm), read_pfm(disp_r_pfm))


def load_sceneflow(root: str, rel: str) -> np.ndarray:
    """SceneFlow layout: ``frames_finalpass/<scene>/left/<name>.png`` with
    PFM disparities under ``disparity/`` (reference stereo.py:14-54)."""
    scene = rel.split("/", 1)[1].rsplit("/", 2)[0]
    name = os.path.splitext(os.path.basename(rel))[0]
    return _load_png_pfm_pair(
        os.path.join(root, "frames_finalpass", scene, "left", f"{name}.png"),
        os.path.join(root, "frames_finalpass", scene, "right", f"{name}.png"),
        os.path.join(root, "disparity", scene, "left", f"{name}.pfm"),
        os.path.join(root, "disparity", scene, "right", f"{name}.pfm"),
    )


def load_sceneflow_legacy(root: str, rel: str) -> np.ndarray:
    """Legacy bundled layout: bare sample names under
    ``frames_finalpass/35mm_forward_fast/{left,right}`` (reference
    stereo.py:57-94; used by the in-repo ``sceneflow_part`` demo data)."""
    base = os.path.join(root, "frames_finalpass", "35mm_forward_fast")
    dbase = os.path.join(root, "disparity", "35mm_forward_fast")
    return _load_png_pfm_pair(
        os.path.join(base, "left", f"{rel}.png"),
        os.path.join(base, "right", f"{rel}.png"),
        os.path.join(dbase, "left", f"{rel}.pfm"),
        os.path.join(dbase, "right", f"{rel}.pfm"),
    )


def load_dfc2019(root: str, rel: str) -> np.ndarray:
    """DFC2019 track-2: ``<rel>_{LEFT,RIGHT}_RGB.tif`` + truth DSP; disparity
    below 0.1 is masked to the ``2*width`` occlusion sentinel (reference
    stereo.py:97-121)."""
    left = _open_image(root + rel + "_LEFT_RGB.tif")
    right = _open_image(root + rel + "_RIGHT_RGB.tif")
    name = rel.rsplit("/", 1)[-1]
    disp = np.asarray(
        _open_image(os.path.join(root, "Track2-Truth", name + "_LEFT_DSP.tif")), np.float32
    ).copy()
    width = left.shape[1]
    disp[disp < 0.1] = 2 * width
    return _finish(standardize_stack(left, right), disp, 2 * width)


def _decode_satellite_disparity(img: np.ndarray) -> np.ndarray:
    """Gray pixels (r==g==b) carry disparity; colored pixels are occlusions
    mapped to 0 (reference satellite.py:7-19, vectorized)."""
    img = np.asarray(img)
    gray = (img[..., 0] == img[..., 1]) & (img[..., 1] == img[..., 2])
    return np.where(gray, img[..., 0], 0).astype(np.float32)


def load_satellite(root: str, rel: str) -> np.ndarray:
    """Old-Tagil satellite pairs: per-sample directory of PNGs (reference
    satellite.py:22-44)."""
    d = os.path.join(root, rel)
    left = _open_image(os.path.join(d, "satiml.png"))
    right = _open_image(os.path.join(d, "satimr.png"))
    disp_l = _decode_satellite_disparity(_open_image(os.path.join(d, "disparityl.png")))
    disp_r = _decode_satellite_disparity(_open_image(os.path.join(d, "disparityr.png")))
    return _finish(standardize_stack(left, right), disp_l, disp_r)


def _gray3(img: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(img)[..., None], 3, axis=2)


def _nan_to_999(img: np.ndarray) -> np.ndarray:
    d = np.asarray(img, np.float32).copy()
    d[np.isnan(d)] = 999
    return d


def load_new_tagil(root: str, rel: str) -> np.ndarray:
    """New-Tagil: grayscale tifs replicated to 3 channels; lidar disparity
    with NaN -> 999 occlusion sentinel (reference new_tagil.py:8-40)."""
    d = os.path.join(root, rel)
    left = _gray3(_open_image(os.path.join(d, "img_L.tif")))
    right = _gray3(_open_image(os.path.join(d, "img_R.tif")))
    disp_l = _nan_to_999(_open_image(os.path.join(d, "disp_L_lidar.tif")))
    disp_r = _nan_to_999(_open_image(os.path.join(d, "disp_R_lidar.tif")))
    return _finish(standardize_stack(left, right), disp_l, disp_r)


_WHU_SHIFT = 64


def load_whu(root: str, rel: str) -> np.ndarray:
    """WHU: the pair is *swapped* (objects move right-to-left), both views are
    cropped by 64 px on opposite edges, and the disparity is negated and
    shifted by 64. Ground truth is stored in the right-disparity channel —
    consume with ``use_left=False`` (reference whu.py:8-60,
    stereo.py:152-153)."""
    d = os.path.join(root, rel)
    # Swapped: the file called "right" becomes our left view.
    left = np.asarray(_open_image(os.path.join(d, "right.tiff")))[:, : -_WHU_SHIFT]
    right = np.asarray(_open_image(os.path.join(d, "left.tiff")))[:, _WHU_SHIFT:]
    disp = np.asarray(_open_image(os.path.join(d, "disp_L.tiff")), np.float32)[:, : -_WHU_SHIFT]
    disp = -disp + _WHU_SHIFT
    width = left.shape[1]
    stack = standardize_stack(_gray3(left), _gray3(right))
    return _finish(stack, 2 * width, disp)


def load_whu2new_tagil(root: str, rel: str) -> np.ndarray:
    """New-Tagil files read with WHU shift conventions, for evaluating a
    WHU-trained model on Tagil (reference whu2new_tagil.py:43-67)."""
    d = os.path.join(root, rel)
    left = np.asarray(_open_image(os.path.join(d, "img_L.tif")))[:, : -_WHU_SHIFT]
    right = np.asarray(_open_image(os.path.join(d, "img_R.tif")))[:, _WHU_SHIFT:]
    disp_l = _nan_to_999(np.asarray(_open_image(os.path.join(d, "disp_L_lidar.tif")))[:, : -_WHU_SHIFT]) + _WHU_SHIFT
    disp_r = _nan_to_999(np.asarray(_open_image(os.path.join(d, "disp_R_lidar.tif")))[:, _WHU_SHIFT:]) + _WHU_SHIFT
    stack = standardize_stack(_gray3(left), _gray3(right))
    return _finish(stack, disp_l, disp_r)


def load_kitti2015(root: str, rel: str) -> np.ndarray:
    """KITTI 2015 training: ``image_2/<frame>.png`` left, ``image_3`` right,
    ``disp_occ_0`` uint16 disparity / 256 with 0 = invalid (upstream LEAStereo
    KITTI fine-tune semantics; the fork's stale train_kitti15.sh — capability
    rebuilt per SURVEY.md §5 config quirk note)."""
    name = os.path.basename(rel)
    left = _open_image(os.path.join(root, "image_2", name))
    right = _open_image(os.path.join(root, "image_3", name))
    disp = np.asarray(
        _open_image(os.path.join(root, "disp_occ_0", name)), np.float32
    ) / 256.0
    return _finish(standardize_stack(left, right), disp, 2 * left.shape[1])


def load_kitti2012(root: str, rel: str) -> np.ndarray:
    """KITTI 2012 training: ``colored_0/1`` pair + ``disp_occ`` / 256."""
    name = os.path.basename(rel)
    left = _open_image(os.path.join(root, "colored_0", name))
    right = _open_image(os.path.join(root, "colored_1", name))
    disp = np.asarray(_open_image(os.path.join(root, "disp_occ", name)), np.float32) / 256.0
    return _finish(standardize_stack(left, right), disp, 2 * left.shape[1])


def load_middlebury(root: str, rel: str) -> np.ndarray:
    """Middlebury MiddEval3: per-scene dir with ``im0.png``/``im1.png`` and
    ``disp0GT.pfm`` (inf = invalid -> occlusion sentinel). The maxdisp-408
    configuration (reference train_md.sh:6, predict_md.sh) pairs with the
    disparity-sharded mesh axis for full-resolution frames."""
    d = os.path.join(root, rel)
    left = _open_image(os.path.join(d, "im0.png"))
    right = _open_image(os.path.join(d, "im1.png"))
    disp = read_pfm(os.path.join(d, "disp0GT.pfm")).copy()
    width = left.shape[1]
    disp[~np.isfinite(disp)] = 2 * width
    return _finish(standardize_stack(left, right), disp, 2 * width)


LOADERS = {
    "sceneflow": load_sceneflow,
    "kitti15": load_kitti2015,
    "kitti15_part": load_kitti2015,
    "kitti12": load_kitti2012,
    "middlebury": load_middlebury,
    "sceneflow_part": load_sceneflow,
    "sceneflow_legacy": load_sceneflow_legacy,
    "dfc2019": load_dfc2019,
    "satellite": load_satellite,
    "new_tagil": load_new_tagil,
    "whu": load_whu,
    "whu2new_tagil": load_whu2new_tagil,
}


def uses_left_disparity(dataset: str) -> bool:
    """WHU stores its ground truth in the right-disparity channel
    (reference stereo.py:148-153)."""
    return dataset != "whu"
