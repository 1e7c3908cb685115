"""PFM (portable float map) reader/writer.

A copy of ``leastereo_tpu/data/pfm.py`` (numpy only): importing the JAX
package's module would run its ``data/__init__.py``, which imports JAX.

The SceneFlow dataset ships disparity ground truth as PFM. Behavior parity
with the reference reader (``dataloaders/datasets/common.py:8-40``): header
``PF``/``Pf``, scale sign encodes endianness, rows stored bottom-up (so we
flip vertically). Unlike the reference we also handle 3-channel ``PF`` files
properly and provide a writer (used by tests and the augmentation tools).
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["read_pfm", "write_pfm"]

_DIMS_RE = re.compile(rb"^\s*(\d+)\s+(\d+)\s*$")


def read_pfm(path) -> np.ndarray:
    """Read a PFM file -> float32 array (H, W) or (H, W, 3), top-down rows."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        m = _DIMS_RE.match(f.readline())
        if not m:
            raise ValueError(f"{path}: malformed PFM dimensions line")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(width * height * channels * 4), dtype=dtype)
        if data.size != width * height * channels:
            raise ValueError(f"{path}: truncated PFM payload")
    shape = (height, width) if channels == 1 else (height, width, channels)
    # PFM stores rows bottom-to-top.
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(path, image: np.ndarray) -> None:
    """Write a float32 array (H, W) or (H, W, 3) as little-endian PFM."""
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        header = b"Pf"
    elif image.ndim == 3 and image.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"unsupported PFM shape {image.shape}")
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # negative scale = little endian
        f.write(np.flipud(image).astype("<f4").tobytes())
