"""Dataset hygiene / conversion / metric-aggregation tools.

Reimplements the reference's one-off scripts as callable functions:
``dataloaders/clean_new_tagil.py`` (validity filters + hide/unhide),
``dataloaders/whu_convert.py`` (flat triplets -> per-sample dirs),
``dataloaders/new_tagil_convert.py`` (epi subdirs -> flat), and
``utils/estimate_eval.py`` (aggregate the evaluation driver's per-frame
``_metrics.txt`` files).

A copy of ``leastereo_tpu/data/tools.py``, held to it by
``tests/test_torch_data_tools.py``.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np

__all__ = [
    "tagil_sample_valid",
    "clean_new_tagil",
    "convert_whu",
    "convert_new_tagil",
    "harvest_midd_eval_logs",
    "aggregate_metrics",
]

REQUIRED_NO_OCC = 0.3
REQUIRED_NON_ZERO = 0.8
HIGH_TH = 500
HIGH_MAX_FRAC = 0.15


def _frac_nonzero(arr: np.ndarray) -> float:
    return np.count_nonzero(arr) / arr.size


def tagil_sample_valid(sample_dir: str) -> bool:
    """Validity filters (reference clean_new_tagil.py:26-46): images >=80%
    nonzero and <15% above 500; disparities >=30% non-NaN."""
    from PIL import Image

    def arr(fn):
        return np.asarray(Image.open(os.path.join(sample_dir, fn)))

    for fn in ("img_L.tif", "img_R.tif"):
        a = arr(fn)
        if _frac_nonzero(a) < REQUIRED_NON_ZERO:
            return False
        if np.count_nonzero(a > HIGH_TH) / a.size >= HIGH_MAX_FRAC:
            return False
    for fn in ("disp_L_lidar.tif", "disp_R_lidar.tif"):
        a = np.asarray(arr(fn), np.float32)
        if np.count_nonzero(~np.isnan(a)) / a.size < REQUIRED_NO_OCC:
            return False
    return True


def clean_new_tagil(dataset_dir: str, dry_run: bool = True) -> dict:
    """Hide invalid sample dirs by dot-prefixing (reference
    clean_new_tagil.py:54-90). Returns {name: valid}."""
    results = {}
    for entry in sorted(os.scandir(dataset_dir), key=lambda e: e.name):
        if not entry.is_dir() or entry.name.startswith("."):
            continue
        valid = tagil_sample_valid(entry.path)
        results[entry.name] = valid
        if not valid and not dry_run:
            shutil.move(entry.path, os.path.join(dataset_dir, f".{entry.name}"))
    return results


_WHU_LEFT_RE = re.compile(r"([A-Z]+)_left_(\d+)\.tiff$")


def convert_whu(in_dir: str, out_dir: str) -> int:
    """Flat ``{left,right,disp}/PFX_*_NUM.tiff`` triplets -> per-sample dirs
    with ``left.tiff / right.tiff / disp_L.tiff`` (reference whu_convert.py)."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for fn in sorted(os.listdir(os.path.join(in_dir, "left"))):
        m = _WHU_LEFT_RE.search(fn)
        if not m:
            continue
        pfx, num = m.group(1), m.group(2)
        dst = os.path.join(out_dir, f"{pfx}_{num}")
        os.makedirs(dst, exist_ok=True)
        shutil.copy(os.path.join(in_dir, "left", fn), os.path.join(dst, "left.tiff"))
        shutil.copy(
            os.path.join(in_dir, "right", f"{pfx}_right_{num}.tiff"),
            os.path.join(dst, "right.tiff"),
        )
        shutil.copy(
            os.path.join(in_dir, "disp", f"{pfx}_disparity_{num}.tiff"),
            os.path.join(dst, "disp_L.tiff"),
        )
        count += 1
    return count


NEW_TAGIL_REQUIRED = frozenset(
    {
        "img_L.tif",
        "img_R.tif",
        "disp_L_lidar.tif",
        "disp_R_lidar.tif",
        "disp_L_lidar0.tif",
        "disp_R_lidar0.tif",
    }
)


def convert_new_tagil(in_dir: str, out_dir: str) -> int:
    """Flatten raw ``<area>/<tile>/epi/`` subtrees into per-sample dirs
    ``<area>_<tile>/`` containing the 6 required files; incomplete samples are
    skipped (reference dataloaders/new_tagil_convert.py)."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for d in sorted(os.scandir(in_dir), key=lambda e: e.name):
        if not d.is_dir():
            continue
        for sd in sorted(os.scandir(d.path), key=lambda e: e.name):
            if not sd.is_dir():
                continue
            epi = os.path.join(sd.path, "epi")
            if not os.path.isdir(epi):
                continue
            if not NEW_TAGIL_REQUIRED.issubset(os.listdir(epi)):
                continue
            sample_dir = os.path.join(out_dir, f"{d.name}_{sd.name}")
            os.makedirs(sample_dir, exist_ok=True)
            for fn in sorted(NEW_TAGIL_REQUIRED):
                shutil.copy(os.path.join(epi, fn), sample_dir)
            count += 1
    return count


_MIDD_EVAL_HEADER = "vis% d_err% o_err% t_err% mean_err"


def harvest_midd_eval_logs(
    in_dir: str, out_file: str = "metrics.txt", log_name: str = "60_midd_eval.log"
) -> dict[str, tuple[float, ...]]:
    """Harvest per-sample ``midd_eval`` log metrics from a raw
    ``<area>/<tile>/`` tree into one summary file and return
    ``{sample: (d_err, o_err, t_err, mean_err)}``
    (reference utils/new_tagil_valids.py)."""
    results: dict[str, tuple[float, ...]] = {}
    with open(out_file, "w") as out:
        for d in sorted(os.scandir(in_dir), key=lambda e: e.name):
            if not d.is_dir():
                continue
            for sd in sorted(os.scandir(d.path), key=lambda e: e.name):
                if not sd.is_dir():
                    continue
                log_path = os.path.join(sd.path, log_name)
                if not os.path.exists(log_path):
                    continue
                with open(log_path) as f:
                    lines = f.readlines()
                if len(lines) < 3 or not lines[1].startswith(_MIDD_EVAL_HEADER):
                    continue
                vals = tuple(map(float, lines[2].split()))
                name = f"{d.name}_{sd.name}"
                results[name] = vals[1:5]
                out.write(f"{name} {vals[1]} {vals[2]} {vals[3]} {vals[4]}\n")
    return results


def aggregate_metrics(eval_dir: str) -> dict:
    """Average all ``*_metrics.txt`` files the evaluation driver wrote
    (reference utils/estimate_eval.py)."""
    sums: dict[str, float] = {}
    n = 0
    for fn in sorted(os.listdir(eval_dir)):
        if not fn.endswith("_metrics.txt"):
            continue
        with open(os.path.join(eval_dir, fn)) as f:
            for line in f:
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                sums[k.strip()] = sums.get(k.strip(), 0.0) + float(v)
        n += 1
    if n == 0:
        return {}
    return {k: v / n for k, v in sums.items()}


def render_new_tagil_previews(
    dataset_dir: str, out_dir: str, list_file: str | None = None
) -> int:
    """8-bit preview renders of the 16/32-bit Tagil tifs
    (reference ``dataloaders/new_tagil_render.py``): per-sample left/right
    image renders rescaled to [0, 250] and a lidar-disparity render rescaled
    to [30, 250] with NaNs (occlusions) rendered black. ``list_file``
    optionally restricts to the sample names it lists (one per line)."""
    from PIL import Image

    keep = None
    if list_file is not None:
        with open(list_file) as fh:
            keep = {line.strip() for line in fh if line.strip()}

    def rescale(arr: np.ndarray, new_min: float, new_max: float) -> np.ndarray:
        lo = np.nanmin(arr)
        rng = max(float(np.nanmax(arr) - lo), 1e-6)
        out = (arr.astype(np.float64) - lo) * (new_max - new_min) / rng + new_min
        out[np.isnan(out)] = 0
        return out.astype(np.uint8)

    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for entry in sorted(os.scandir(dataset_dir), key=lambda e: e.name):
        if not entry.is_dir() or entry.name.startswith("."):
            continue
        if keep is not None and entry.name not in keep:
            continue
        for fn, lo_hi in (
            ("img_L.tif", (0, 250)),
            ("img_R.tif", (0, 250)),
            ("disp_L_lidar0.tif", (30, 250)),
            ("disp_L_lidar.tif", (30, 250)),
        ):
            src = os.path.join(entry.path, fn)
            if not os.path.exists(src):
                continue
            arr = np.asarray(Image.open(src), np.float32)
            img = rescale(arr, *lo_hi)
            Image.fromarray(img).save(
                os.path.join(out_dir, f"{entry.name}_render_{fn.removesuffix('.tif')}.png")
            )
            count += 1
    return count


def make_satellite_list(dataset_dir: str, out_dir: str, seed: int = 0, train_frac: float = 0.9) -> None:
    """90/10 train/val split over per-sample dirs
    (reference utils/make_satellite_list.py)."""
    from .lists import write_list

    rng = np.random.default_rng(seed)
    names = sorted(d for d in next(os.walk(dataset_dir))[1] if not d.startswith("."))
    rng.shuffle(names)
    n_train = int(len(names) * train_frac)
    write_list(out_dir, "train", names[:n_train])
    write_list(out_dir, "val", names[n_train:])
