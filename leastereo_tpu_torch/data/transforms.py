"""Host-side (numpy) sample transforms.

The loaders produce an 8-channel float32 stack ``(8, H, W)``:
channels 0-2 = standardized left RGB, 3-5 = standardized right RGB,
6 = left disparity, 7 = right disparity — the same convention as the
reference (``dataloaders/datasets/common.py``), kept so pad/crop logic treats
image and disparity channels uniformly. Transforms return NHWC-ready
``(left (H,W,3), right (H,W,3), disparity (H,W))`` float32 arrays — the
NHWC layout ``LEAStereo.forward`` takes.

A copy of ``leastereo_tpu/data/transforms.py`` (numpy only), kept
bit-identical to it (``tests/test_torch_data.py``).

Randomness is explicit: every stochastic transform takes a
``np.random.Generator`` so epochs are reproducible and per-worker streams
never collide (the reference uses the global ``random`` module).
"""

from __future__ import annotations

import numpy as np

from ..utils.tracing import span

__all__ = [
    "standardize_stack",
    "train_transform",
    "test_transform",
    "PAD_DISP_SENTINEL",
]

# Disparity value written into padded regions so the validity mask
# (0.001 < d < maxdisp) rejects them (reference common.py:49, 56, 104).
PAD_DISP_SENTINEL = 1000.0


def standardize_stack(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Per-image, per-channel standardization into an 8-channel stack.

    Parity with reference ``set_rgb_layers`` (common.py:119-131):
    each RGB channel is centered/scaled by its own mean/std. Disparity
    channels (6, 7) are left zeroed for the caller to fill.
    """
    with span("standardize"):
        h, w = left.shape[:2]
        stack = np.zeros((8, h, w), np.float32)
        for out, img in ((stack[0:3], left), (stack[3:6], right)):
            img = np.asarray(img, np.float32)
            for c in range(3):
                ch = img[:, :, c]
                out[c] = (ch - ch.mean()) / ch.std()
        return stack


def _pad_to(stack: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Zero-pad to (out_h, out_w), content bottom-right aligned, left-disparity
    channel pre-filled with the pad sentinel (reference common.py:47-57)."""
    _, h, w = stack.shape
    out = np.zeros((8, out_h, out_w), np.float32)
    out[6] = PAD_DISP_SENTINEL
    out[:, out_h - h :, out_w - w :] = stack
    return out


def train_transform(
    stack: np.ndarray,
    crop_height: int,
    crop_width: int,
    rng: np.random.Generator,
    use_left: bool = True,
    left_right: bool = False,
    shift: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random training crop with optional x-shift jitter and left/right swap.

    Behavior parity with reference ``train_transform`` (common.py:43-91):

    * undersized inputs are padded to ``(crop + shift)`` with the disparity
      sentinel;
    * ``shift > 0``: the left image and disparity are cropped at
      ``start_x + shift_x`` while the right stays at ``start_x``, and the
      disparity is corrected by ``-shift_x`` — photometric-free x-jitter;
    * ``left_right``: with probability 1/2 swap the pair and regress the
      *right* disparity (channel 7), treating the right image as left;
    * ``use_left=False`` (WHU): ground truth lives in channel 7.
    """
    _, h, w = stack.shape

    if h > crop_height and w <= crop_width:
        stack = _pad_to(stack, h + shift, crop_width + shift)
        _, h, w = stack.shape
    if h <= crop_height and w <= crop_width:
        stack = _pad_to(stack, crop_height + shift, crop_width + shift)
        _, h, w = stack.shape

    if shift > 0:
        start_x = int(rng.integers(0, w - crop_width + 1))
        shift_x = int(rng.integers(-shift, shift + 1))
        if shift_x + start_x < 0 or shift_x + start_x + crop_width > w:
            shift_x = 0
        start_y = int(rng.integers(0, h - crop_height + 1))
        ys = slice(start_y, start_y + crop_height)
        left = stack[0:3, ys, start_x + shift_x : start_x + shift_x + crop_width]
        right = stack[3:6, ys, start_x : start_x + crop_width]
        target = stack[6, ys, start_x + shift_x : start_x + shift_x + crop_width] - shift_x
        return _chw_to_hwc(left), _chw_to_hwc(right), np.ascontiguousarray(target)

    if h <= crop_height and w <= crop_width:
        stack = _pad_to(stack, crop_height, crop_width)
    else:
        start_x = int(rng.integers(0, w - crop_width + 1))
        start_y = int(rng.integers(0, h - crop_height + 1))
        stack = stack[:, start_y : start_y + crop_height, start_x : start_x + crop_width]

    if use_left or (left_right and rng.integers(0, 2) == 0):
        return _chw_to_hwc(stack[0:3]), _chw_to_hwc(stack[3:6]), np.ascontiguousarray(stack[6])
    # Regress the right disparity, swapping the roles of the two views
    # (reference common.py:85-91).
    return _chw_to_hwc(stack[3:6]), _chw_to_hwc(stack[0:3]), np.ascontiguousarray(stack[7])


def test_transform(
    stack: np.ndarray,
    crop_height: int,
    crop_width: int,
    use_left: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic eval crop: sentinel-pad if small, center-crop if large
    (reference ``test_transform`` common.py:94-116)."""
    _, h, w = stack.shape
    if h <= crop_height and w <= crop_width:
        stack = _pad_to(stack, crop_height, crop_width)
    else:
        start_x = (w - crop_width) // 2
        start_y = (h - crop_height) // 2
        stack = stack[:, start_y : start_y + crop_height, start_x : start_x + crop_width]
    target = stack[6] if use_left else stack[7]
    return _chw_to_hwc(stack[0:3]), _chw_to_hwc(stack[3:6]), np.ascontiguousarray(target)


def _chw_to_hwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x, (1, 2, 0)))
