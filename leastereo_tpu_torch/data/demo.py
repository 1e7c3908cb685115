"""Synthetic bundled smoke dataset generator.

The reference ships 5 real SceneFlow stereo pairs under
``dataset/sceneflow_part/`` (``frames_finalpass/35mm_forward_fast/...`` +
PFM ground truth, wired via ``mypath.py:12-13``) so every driver can run a
zero-download CPU smoke. Shipping licensed SceneFlow frames is not an option
here, so this module *generates* an equivalent: layered fronto-parallel
scenes with exact integer ground-truth disparity, rendered consistently into
both views (a layer at disparity ``d`` appears shifted ``d`` px left in the
right view; nearer layers occlude farther ones independently per view, which
also yields the correct right-view disparity map).

The output matches the reference bundle's layout byte-for-byte in structure:

    <root>/frames_finalpass/35mm_forward_fast/{left,right}/000N.png
    <root>/disparity/35mm_forward_fast/{left,right}/000N.pfm

so ``load_sceneflow`` / ``load_sceneflow_legacy`` and the ``sceneflow_part``
list sets consume it unchanged. Deterministic per (seed, index).

A copy of ``leastereo_tpu/data/demo.py``, held to it by
``tests/test_torch_data_tools.py``. It keeps the reference's quirk that
:func:`sparsify_disparity` casts ``round(d * 256)`` to uint16 unclipped, so
disparities of 256 px or more wrap (ROADMAP.md §C).
"""

from __future__ import annotations

import os

import numpy as np

from .pfm import write_pfm

__all__ = [
    "render_stereo_scene",
    "generate_demo_dataset",
    "generate_kitti_demo_dataset",
]


def _smooth_noise(rng: np.random.Generator, h: int, w: int, scales=(8, 32, 128)) -> np.ndarray:
    """Band-limited random texture in [0, 1] (compresses well as PNG)."""
    out = np.zeros((h, w), np.float32)
    for s in scales:
        grid = rng.random((h // s + 2, w // s + 2)).astype(np.float32)
        ys = np.linspace(0, grid.shape[0] - 1.001, h)
        xs = np.linspace(0, grid.shape[1] - 1.001, w)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = (
            grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + grid[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + grid[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + grid[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        out += g
    out -= out.min()
    out /= max(out.max(), 1e-6)
    return out


def render_stereo_scene(
    seed: int,
    height: int = 324,
    width: int = 576,
    max_disp: int = 64,
    num_objects: int = 5,
):
    """Render one synthetic stereo pair with exact ground truth.

    Returns ``(left_rgb u8, right_rgb u8, disp_left f32, disp_right f32)``.
    """
    rng = np.random.default_rng(seed)
    ext = width + max_disp  # textures live on an extended canvas

    # Layers far -> near: (integer disparity, rgb texture on extended canvas,
    # mask in *world* (left-view) coordinates on the extended canvas).
    layers = []
    bg_disp = int(rng.integers(4, 12))
    bg_tex = np.stack(
        [_smooth_noise(rng, height, ext) for _ in range(3)], axis=-1
    )
    layers.append((bg_disp, bg_tex, np.ones((height, ext), bool)))

    disps = np.sort(rng.integers(bg_disp + 4, max_disp, size=num_objects))
    yy = np.arange(height)[:, None]
    xx = np.arange(ext)[None, :]
    for d in disps:  # ascending disparity = far -> near
        tex = np.stack([_smooth_noise(rng, height, ext) for _ in range(3)], axis=-1)
        tint = rng.random(3).astype(np.float32) * 0.6 + 0.4
        tex = tex * tint[None, None, :]
        cy = rng.integers(height // 6, 5 * height // 6)
        cx = rng.integers(ext // 6, 5 * ext // 6)
        ry = rng.integers(height // 10, height // 3)
        rx = rng.integers(width // 10, width // 3)
        if rng.random() < 0.5:
            mask = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        else:
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        layers.append((int(d), tex, mask))

    left = np.zeros((height, width, 3), np.float32)
    right = np.zeros((height, width, 3), np.float32)
    disp_l = np.zeros((height, width), np.float32)
    disp_r = np.zeros((height, width), np.float32)
    for d, tex, mask in layers:  # far -> near: nearer layers overwrite
        # Left view: world x maps to image x. Keep x in [d, width): every
        # visible pixel then has a valid in-image right correspondence.
        ml = mask[:, :width].copy()
        ml[:, :d] = False
        left[ml] = tex[:, :width][ml]
        disp_l[ml] = d
        # Right view: world x maps to image x - d.
        mr = mask[:, d : width + d]
        right[mr] = tex[:, d : width + d][mr]
        disp_r[mr] = d
    left_u8 = np.clip(left * 255.0, 0, 255).astype(np.uint8)
    right_u8 = np.clip(right * 255.0, 0, 255).astype(np.uint8)
    return left_u8, right_u8, disp_l, disp_r


def generate_demo_dataset(
    root: str = "dataset/sceneflow_part",
    num_pairs: int = 5,
    height: int = 324,
    width: int = 576,
    max_disp: int = 64,
    seed: int = 0,
) -> list[str]:
    """Write the bundled smoke dataset; returns the list-file entries."""
    from PIL import Image

    scene = "35mm_forward_fast"
    for sub in ("left", "right"):
        os.makedirs(os.path.join(root, "frames_finalpass", scene, sub), exist_ok=True)
        os.makedirs(os.path.join(root, "disparity", scene, sub), exist_ok=True)
    entries = []
    for i in range(num_pairs):
        name = f"{i + 1:04d}"
        left, right, dl, dr = render_stereo_scene(
            seed * 1000 + i, height, width, max_disp
        )
        Image.fromarray(left).save(
            os.path.join(root, "frames_finalpass", scene, "left", f"{name}.png")
        )
        Image.fromarray(right).save(
            os.path.join(root, "frames_finalpass", scene, "right", f"{name}.png")
        )
        write_pfm(os.path.join(root, "disparity", scene, "left", f"{name}.pfm"), dl)
        write_pfm(os.path.join(root, "disparity", scene, "right", f"{name}.pfm"), dr)
        entries.append(f"frames_finalpass/{scene}/left/{name}.png")
    return entries


def sparsify_disparity(disp: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Lidar-like sparse ground truth from a dense disparity map.

    KITTI's ``disp_occ_0`` maps are semi-dense Velodyne accumulations: density
    ramps from near-zero at the top of the frame to ~60% at the bottom, with
    whole scan rows absent. Model that shape: a per-pixel Bernoulli keep with
    a bottom-heavy ramp, every third row dropped entirely (scan-line gaps),
    and the result quantised to the uint16 ``round(d * 256)`` wire format with
    0 = invalid (reference dataset semantics; see ``load_kitti2015``).
    """
    h, w = disp.shape
    ramp = 0.08 + 0.6 * (np.arange(h, dtype=np.float32)[:, None] / h) ** 1.5
    keep = rng.random((h, w)) < ramp
    keep &= (np.arange(h) % 3 != 0)[:, None]  # missing scan lines
    keep &= disp > 0
    return np.round(disp * 256.0).astype(np.uint16) * keep.astype(np.uint16)


def generate_kitti_demo_dataset(
    root: str = "dataset/kitti15_part",
    num_pairs: int = 5,
    height: int = 324,
    width: int = 576,
    max_disp: int = 64,
    seed: int = 7,
) -> list[str]:
    """Write a KITTI-2015-layout bundled smoke dataset; returns list entries.

    Same synthetic scene renderer as :func:`generate_demo_dataset`, emitted in
    the KITTI 2015 ``training/`` layout consumed by ``load_kitti2015``
    (reference fine-tune recipe ``train_kitti15.sh:1-18``):

        <root>/image_2/<frame>_10.png     left
        <root>/image_3/<frame>_10.png     right
        <root>/disp_occ_0/<frame>_10.png  uint16 disp*256, 0 = invalid

    with the dense ground truth sparsified to lidar-like density so the
    sparse-GT masked-loss path (``validity_mask``) is exercised for real.
    """
    from PIL import Image

    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    entries = []
    rng = np.random.default_rng(seed)
    for i in range(num_pairs):
        name = f"{i:06d}_10.png"
        left, right, dl, _ = render_stereo_scene(
            seed * 1000 + i, height, width, max_disp
        )
        Image.fromarray(left).save(os.path.join(root, "image_2", name))
        Image.fromarray(right).save(os.path.join(root, "image_3", name))
        sparse = sparsify_disparity(dl, rng)
        Image.fromarray(sparse).save(os.path.join(root, "disp_occ_0", name))
        entries.append(f"image_2/{name}")
    return entries
