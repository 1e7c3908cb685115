"""Offline augmentation pipelines (dataset generators).

Reimplements the reference's torchvision/cv2/albumentations pipelines
(``dataloaders/augmentations/new_tagil_aug.py``, ``augmentations/satellite.py``)
as pure-numpy sample transforms + generator pipelines. All randomness flows
from an explicit ``np.random.Generator``.

A sample is a dict of numpy arrays:
  new_tagil:  {left, right, displ, dispr, disp0l, disp0r}  (grayscale, NaN=occ)
  satellite:  {left, right, displ, dispr}                  (RGB uint8)

A copy of ``leastereo_tpu/data/augment.py``, held to it by
``tests/test_torch_data_tools.py``. It keeps the reference's quirk that
:func:`shift_sample` adds the shift to every disparity pixel, the invalid
zeros of sparse ground truth included (ROADMAP.md §C).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "hflip_sample",
    "vflip_sample",
    "shift_sample",
    "scale_sample",
    "random_crop_sample",
    "forward_warp_right",
    "warp_right_from_right",
    "new_tagil_pipeline",
    "satellite_pipeline",
    "run_new_tagil_aug",
    "run_satellite_aug",
]

_DISP_KEYS = ("displ", "dispr", "disp0l", "disp0r")
_IMG_KEYS = ("left", "right")


def hflip_sample(s: dict) -> dict:
    """Horizontal flip swaps the views AND the left/right disparities
    (reference new_tagil_aug.py:88-97)."""
    out = dict(s)
    out["left"], out["right"] = s["right"][:, ::-1], s["left"][:, ::-1]
    if "displ" in s:
        out["displ"], out["dispr"] = s["dispr"][:, ::-1], s["displ"][:, ::-1]
    if "disp0l" in s:
        out["disp0l"], out["disp0r"] = s["disp0r"][:, ::-1], s["disp0l"][:, ::-1]
    return out


def vflip_sample(s: dict) -> dict:
    return {k: (v[::-1] if isinstance(v, np.ndarray) else v) for k, v in s.items()}


def shift_sample(s: dict, shift: int) -> dict:
    """Disparity shift by cropping opposite edges and offsetting the maps
    (reference new_tagil_aug.py:131-168): positive shift crops the left
    image's right edge and the right image's left edge, adding ``shift``."""
    if shift == 0:
        return dict(s)
    out = {"name": s.get("name")}
    a = abs(shift)

    def crop_r(x):
        return x[:, :-a]

    def crop_l(x):
        return x[:, a:]

    left_crop, right_crop = (crop_r, crop_l) if shift > 0 else (crop_l, crop_r)
    out["left"] = left_crop(s["left"])
    out["right"] = right_crop(s["right"])
    for k in _DISP_KEYS:
        if k in s:
            crop = left_crop if k.endswith("l") else right_crop
            out[k] = crop(s[k]) + shift
    return out


def scale_sample(s: dict, scale: float) -> dict:
    """Spatial rescale; disparity values rescale with x (reference
    new_tagil_aug.py:383-421: bilinear images, nearest disparities)."""
    out = {"name": s.get("name")}
    for k in _IMG_KEYS:
        out[k] = _resize_bilinear(s[k], scale)
    for k in _DISP_KEYS:
        if k in s:
            out[k] = np.round(_resize_nearest(s[k], scale) * scale)
    return out


def _resize_bilinear(img: np.ndarray, scale: float) -> np.ndarray:
    h, w = img.shape[:2]
    nh, nw = int(h * scale), int(w * scale)
    ys = np.clip((np.arange(nh) + 0.5) / scale - 0.5, 0, h - 1)
    xs = np.clip((np.arange(nw) + 0.5) / scale - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _resize_nearest(img: np.ndarray, scale: float) -> np.ndarray:
    h, w = img.shape[:2]
    nh, nw = int(h * scale), int(w * scale)
    ys = np.clip((np.arange(nh) / scale).astype(int), 0, h - 1)
    xs = np.clip((np.arange(nw) / scale).astype(int), 0, w - 1)
    return img[ys][:, xs]


def random_crop_sample(s: dict, crop_hw: tuple[int, int], rng: np.random.Generator) -> dict:
    h, w = s["left"].shape[:2]
    ch, cw = crop_hw
    top = int(rng.integers(0, max(h - ch, 1)))
    left = int(rng.integers(0, max(w - cw, 1)))
    out = {"name": s.get("name")}
    for k, v in s.items():
        if isinstance(v, np.ndarray):
            out[k] = v[top : top + ch, left : left + cw]
    return out


def _median3(x: np.ndarray) -> np.ndarray:
    """3x3 median filter with edge replication (cv2.medianBlur analog)."""
    p = np.pad(x, 1, mode="edge")
    stack = np.stack([p[i : i + x.shape[0], j : j + x.shape[1]] for i in range(3) for j in range(3)])
    return np.median(stack, axis=0)


def forward_warp_right(image: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """Forward-splat ``image`` to target columns ``x - disp`` with 2-tap
    linear weights and nearest-surface (min-weight) z-buffering; unhit pixels
    stay 0 (occlusions). Capability parity with reference ``project_image``
    (new_tagil_aug.py:223-278), vectorized per column."""
    h, w = image.shape[:2]
    img = image.astype(np.float64)
    targets = np.arange(w)[None, :] - disp  # (H, W) fractional target columns
    out = np.zeros((2, h, w))
    best = np.full((2, h, w), np.inf)
    rows = np.arange(h)
    # Iterate source columns right-to-left; closer (smaller weight) wins.
    for col in range(w - 1, -1, -1):
        loc = targets[:, col]
        for tap, (locf, weight) in enumerate(
            (
                (np.ceil(loc).astype(int), np.ceil(loc) - loc),
                (np.floor(loc).astype(int), 1 - (np.ceil(loc) - loc)),
            )
        ):
            m = (locf >= 0) & (locf < w)
            m[m] &= best[tap, rows[m], locf[m]] > weight[m]
            best[tap, rows[m], locf[m]] = weight[m]
            out[tap, rows[m], locf[m]] = img[m, col]
    hit = np.isfinite(best)
    b = np.where(hit, best, 0.0)  # unhit taps contribute weight 0
    wsum = b[0] + b[1]
    both = hit.all(axis=0) & (wsum > 0)
    # Blend the two taps by their complementary weights where both hit.
    blend = np.where(
        both,
        (out[0] * b[1] + out[1] * b[0]) / np.maximum(wsum, 1e-7),
        np.where(hit[0], out[0], np.where(hit[1], out[1], 0.0)),
    )
    return blend


def warp_right_from_right(s: dict, scale: float) -> dict:
    """Disparity-aware right-view re-synthesis at baseline ``scale``
    (reference ``warp_right_from_right`` new_tagil_aug.py:352-375): warp the
    right image by ``(scale-1) * disp_r``, scale the left disparities, and
    drop the right disparity (set NaN)."""
    h, w = s["right"].shape[:2]
    delta = scale - 1.0
    dispr = np.nan_to_num(np.asarray(s["disp0r"], np.float64), nan=0.0)
    dispr = _median3(dispr)
    if delta >= 0:
        warped = forward_warp_right(s["right"], np.round(delta * dispr))
    else:  # mirror, warp, mirror back (reference warp_right new_tagil_aug.py:322-348)
        warped = forward_warp_right(s["right"][:, ::-1], np.round(-delta * dispr[:, ::-1]))[:, ::-1]
    warped = _median3(warped)
    out = dict(s)
    out["right"] = warped
    for k in ("displ", "disp0l"):
        if k in s:
            out[k] = np.round(s[k] * scale)
    for k in ("dispr", "disp0r"):
        if k in s:
            out[k] = np.full((h, w), np.nan)
    return out


# ------------------------------------------------------------ pipelines ----


def new_tagil_pipeline(samples, rng: np.random.Generator, crop_hw=(450, 700), n_crops=5):
    """hflip(0.5) -> warp(0.5, ±0.3) -> shift(0.5, ±32) -> scale(0.3, ±0.2)
    -> 5 random crops -> vflip(0.5) (reference new_tagil_aug.py:446-453)."""
    for s in samples:
        if rng.random() < 0.5:
            s = hflip_sample(s)
        if rng.random() < 0.5:
            s = warp_right_from_right(s, 1 + float(rng.uniform(-0.3, 0.3)))
        if rng.random() < 0.5:
            min_disp = np.nanmin(s["disp0l"]) if "disp0l" in s else 0
            lo = max(-min_disp + 3, -32)
            s = shift_sample(s, int(rng.integers(lo, 33)))
        if rng.random() < 0.3:
            s = scale_sample(s, 1 + float(rng.uniform(-0.2, 0.2)))
        for _ in range(n_crops):
            c = random_crop_sample(s, crop_hw, rng)
            if rng.random() < 0.5:
                c = vflip_sample(c)
            yield c


def satellite_pipeline(samples, rng: np.random.Generator, crop_hw=(192, 384), n_iter=10):
    """Synchronized random crop + vflip(0.5) + brightness/contrast + gaussian
    noise, x``n_iter`` amplification (reference augmentations/satellite.py)."""
    for s in samples:
        for _ in range(n_iter):
            c = random_crop_sample(s, crop_hw, rng)
            if rng.random() < 0.5:
                c = vflip_sample(c)
            brightness = float(rng.uniform(-0.1, 0.2))
            contrast = 1 + float(rng.uniform(-0.1, 0.2))
            for k in _IMG_KEYS:
                img = c[k].astype(np.float32)
                img = np.clip(img * contrast + brightness * 255, 0, 255)
                img = img + rng.normal(0, 5, img.shape)
                c[k] = np.clip(img, 0, 255).astype(np.uint8)
            yield c


# ------------------------------------------------------------- disk IO -----


def _read_tagil_sample(root: str, name: str) -> dict:
    from PIL import Image

    def rd(fn):
        return np.asarray(Image.open(os.path.join(root, name, fn)))

    return {
        "name": name,
        "left": rd("img_L.tif"),
        "right": rd("img_R.tif"),
        "displ": rd("disp_L_lidar.tif").astype(np.float32),
        "dispr": rd("disp_R_lidar.tif").astype(np.float32),
        "disp0l": rd("disp_L_lidar0.tif").astype(np.float32),
        "disp0r": rd("disp_R_lidar0.tif").astype(np.float32),
    }


def _store_tagil_sample(root: str, s: dict, idx: int) -> None:
    from PIL import Image

    d = os.path.join(root, f"{s['name']}_{idx}")
    os.makedirs(d, exist_ok=True)
    names = {
        "left": "img_L.tif",
        "right": "img_R.tif",
        "displ": "disp_L_lidar.tif",
        "dispr": "disp_R_lidar.tif",
        "disp0l": "disp_L_lidar0.tif",
        "disp0r": "disp_R_lidar0.tif",
    }
    for k, fn in names.items():
        arr = s[k]
        mode = "F" if arr.dtype.kind == "f" else None
        Image.fromarray(arr.astype(np.float32) if mode == "F" else arr, mode=mode).save(
            os.path.join(d, fn)
        )


def run_new_tagil_aug(in_dir: str, list_file: str, out_dir: str, seed: int = 0) -> int:
    """Offline dataset amplification (reference new_tagil_aug.py __main__)."""
    rng = np.random.default_rng(seed)
    with open(list_file) as f:
        names = [l.strip() for l in f if l.strip()]
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    samples = (_read_tagil_sample(in_dir, n) for n in names)
    for s in new_tagil_pipeline(samples, rng):
        _store_tagil_sample(out_dir, s, count)
        count += 1
    return count


def run_satellite_aug(in_dir: str, out_dir: str, seed: int = 0) -> int:
    """Offline satellite amplification (reference augmentations/satellite.py)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(d for d in next(os.walk(in_dir))[1] if not d.startswith("."))
    count = 0

    def read(n):
        d = os.path.join(in_dir, n)
        return {
            "name": n,
            "left": np.asarray(Image.open(os.path.join(d, "satiml.png"))),
            "right": np.asarray(Image.open(os.path.join(d, "satimr.png"))),
            "displ": np.asarray(Image.open(os.path.join(d, "disparityl.png"))),
            "dispr": np.asarray(Image.open(os.path.join(d, "disparityr.png"))),
        }

    for s in satellite_pipeline((read(n) for n in names), rng):
        d = os.path.join(out_dir, f"{s['name']}_{count}")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(s["left"]).save(os.path.join(d, "satiml.png"))
        Image.fromarray(s["right"]).save(os.path.join(d, "satimr.png"))
        Image.fromarray(np.asarray(s["displ"]).astype(np.uint8)).save(os.path.join(d, "disparityl.png"))
        Image.fromarray(np.asarray(s["dispr"]).astype(np.uint8)).save(os.path.join(d, "disparityr.png"))
        count += 1
    return count
