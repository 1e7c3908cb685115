"""Turbo colormap for disparity rendering.

Replaces the reference's hardcoded 256-entry table (``utils/colorize.py``)
with Google's published polynomial approximation of the same Turbo colormap,
evaluated at any resolution.

A copy of ``leastereo_tpu/utils/colorize.py`` (numpy only), byte-equal in
its output (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import numpy as np

from .tracing import span

__all__ = ["turbo_colormap", "colorize_disparity"]

# Turbo polynomial coefficients (degree 5), google/turbo reference
# approximation: c0 + c1 x + ... + c5 x^5 per channel, x in [0, 1].
_R = (0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943)
_G = (0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604)
_B = (0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973)


def turbo_colormap(n: int = 256) -> np.ndarray:
    """(n, 3) float RGB table in [0, 1]."""
    x = np.linspace(0.0, 1.0, n)
    powers = np.stack([x**i for i in range(6)], axis=1)  # (n, 6)
    rgb = np.stack(
        [powers @ np.asarray(c) for c in (_R, _G, _B)], axis=1
    )  # (n, 3)
    return np.clip(rgb, 0.0, 1.0)


def colorize_disparity(
    disp: np.ndarray, vmin: float | None = None, vmax: float | None = None
) -> np.ndarray:
    """Disparity map (H, W) -> uint8 RGB (H, W, 3) via Turbo
    (reference predict.py:245-246 rendering path)."""
    with span("colorize"):
        disp = np.asarray(disp, np.float32)
        finite = np.isfinite(disp)
        if vmin is None:
            vmin = float(disp[finite].min()) if finite.any() else 0.0
        if vmax is None:
            vmax = float(disp[finite].max()) if finite.any() else 1.0
        scale = max(vmax - vmin, 1e-6)
        idx = np.clip((disp - vmin) / scale, 0.0, 1.0)
        idx = np.nan_to_num(idx, nan=0.0)
        table = turbo_colormap(256)
        return (table[(idx * 255).astype(np.int32)] * 255).astype(np.uint8)
