"""ctypes bindings for the native host-IO library (``csrc/stereo_io.cpp``,
the port's copy of ``native/stereo_io.cpp``; port of
``leastereo_tpu/data/native.py``).

Decodes PNG + PFM and assembles the standardized 8-channel stack in C++ with
no Python in the loop. At first use the library is built with ``g++ -O3
-march=native -shared -fPIC ... -lpng16`` (the flags of
``scripts/build_native.sh``) into ``leastereo_tpu_torch/build/`` (listed in
``.gitignore``), and rebuilt when the source is newer. Where ``g++`` or
``png.h`` is absent, or the built library does not load (a libpng that the
linker finds but the run-time loader does not), :func:`native_available` is
False and the loaders decode with PIL, as the JAX package does without its
library; which reader runs, and why, is logged once. Any other build
failure raises with the compiler's stderr. This is host decoding: the card
is not involved.
"""

from __future__ import annotations

import ctypes
import logging
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

__all__ = ["native_available", "load_stereo_sample_native", "read_pfm_native"]

logger = logging.getLogger(__name__)

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "stereo_io.cpp"
_LIB_PATH = _PKG / "build" / "libstereo_io.so"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_MAX_PIXELS = 8192 * 8192
_lib: ctypes.CDLL | None = None
_missing: str | None = None  # why the toolchain cannot build the library


def _toolchain_missing() -> str | None:
    """``None`` when ``g++`` and libpng's header are present; else which is not."""
    if shutil.which("g++") is None:
        return "g++ not on PATH"
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <png.h>\n",
                           capture_output=True, text=True)
    return None if probe.returncode == 0 else "png.h not found by g++"


def _build() -> None:
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename: concurrent first uses (test
    # workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_PATH.parent)
    os.close(fd)
    proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC), "-lpng16"], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {_SRC.name} ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, _LIB_PATH)


def _load() -> ctypes.CDLL | None:
    global _lib, _missing
    if _lib is not None or _missing is not None:
        return _lib
    if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
        _missing = _toolchain_missing()
        if _missing is not None:
            logger.warning("native PNG/PFM reader unavailable (%s): decoding with PIL", _missing)
            return None
        _build()
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as exc:
        _missing = f"{_LIB_PATH.name} does not load: {exc}"
        logger.warning("native PNG/PFM reader unavailable (%s): decoding with PIL", _missing)
        return None
    s, p, ip, i = ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int), ctypes.c_int
    lib.read_pfm.argtypes = [s, p, ip, ip, i]
    lib.read_png_rgb.argtypes = [s, p, ip, ip, i]
    lib.png_dims.argtypes = [s, ip, ip]
    lib.load_stereo_sample.argtypes = [s, s, s, s, p, ip, ip, i]
    for fn in (lib.read_pfm, lib.read_png_rgb, lib.png_dims, lib.load_stereo_sample):
        fn.restype = ctypes.c_int
    logger.info("PNG/PFM pairs decoded by the native reader %s", _LIB_PATH)
    _lib = lib
    return lib


def _png_dims(lib, path: str) -> tuple[int, int]:
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.png_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)):
        raise IOError(f"cannot read PNG header: {path}")
    return h.value, w.value


def native_available() -> bool:
    """True when the library is built (building it now if need be)."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native reader unavailable: {_missing}")
    return lib


def read_pfm_native(path: str) -> np.ndarray:
    lib = _require()
    out = np.empty(_MAX_PIXELS, np.float32)  # PFM header has no cheap probe; cap
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.read_pfm(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(h),
        ctypes.byref(w),
        _MAX_PIXELS,
    )
    if rc != 0:
        raise IOError(f"read_pfm({path}) failed with code {rc}")
    return out[: h.value * w.value].reshape(h.value, w.value).copy()


def load_stereo_sample_native(
    left_png: str, right_png: str, disp_left_pfm: str, disp_right_pfm: str
) -> np.ndarray:
    """-> (8, H, W) standardized stack, fully assembled in C++."""
    lib = _require()
    ph, pw = _png_dims(lib, str(left_png))
    n_px = ph * pw
    stack = np.empty(8 * n_px, np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.load_stereo_sample(
        str(left_png).encode(),
        str(right_png).encode(),
        str(disp_left_pfm).encode(),
        str(disp_right_pfm).encode(),
        stack.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(h),
        ctypes.byref(w),
        n_px,
    )
    if rc != 0:
        raise IOError(f"load_stereo_sample failed with code {rc}")
    n = h.value * w.value
    return stack[: 8 * n].reshape(8, h.value, w.value).copy()
