"""A frozen copy of the Turbo render that the predict driver writes: Google's
degree-5 polynomial of the Turbo colormap, 256 entries, the map scaled to
its own finite minimum and maximum."""

from __future__ import annotations

import numpy as np

__all__ = ["turbo_render"]

_R = (0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943)
_G = (0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604)
_B = (0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973)


def turbo_render(disp: np.ndarray) -> np.ndarray:
    """``(h, w)`` disparity -> ``(h, w, 3)`` uint8 RGB."""
    disp = np.asarray(disp, np.float32)
    finite = np.isfinite(disp)
    vmin = float(disp[finite].min()) if finite.any() else 0.0
    vmax = float(disp[finite].max()) if finite.any() else 1.0
    idx = np.nan_to_num(np.clip((disp - vmin) / max(vmax - vmin, 1e-6), 0.0, 1.0), nan=0.0)
    x = np.linspace(0.0, 1.0, 256)
    powers = np.stack([x**i for i in range(6)], axis=1)
    table = np.clip(np.stack([powers @ np.asarray(c) for c in (_R, _G, _B)], axis=1), 0.0, 1.0)
    return (table[(idx * 255).astype(np.int32)] * 255).astype(np.uint8)
