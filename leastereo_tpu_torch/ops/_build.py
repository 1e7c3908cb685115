"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc``, all started together,
and the objects linked into one shared library with a plain C interface, at
first use, into ``leastereo_tpu_torch/build/`` (listed in ``.gitignore``),
and loaded with ``ctypes``. Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.
The library is rebuilt when a source or header (``*.cu``, ``*.cuh``) is
newer than it. It links no ``-lcuda``: the one libcuda function it needs
(the TMA tensor-map encoder) is looked up through the CUDA runtime.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = [
    "load_kernels",
    "BUILD_DIR",
    "check",
    "band_smem_bytes",
    "head_sm90_entry_channels",
    "HEAD_SM90_ENTRIES",
    "head_sm90_smem_bytes",
    "head_sm90_f32_stages",
    "head_sm90_f32_smem_bytes",
    "SMEM_LIMIT",
]

# Tile geometry of csrc/soft_argmin_heads.cu: BAND_TILE_H x BAND_TILE_W
# low-res pixels per block of the band kernel. The shared-memory formulas
# below are checked against the library's own when it loads.
BAND_TILE_H, BAND_TILE_W = 1, 32
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper (227 KB)

# Geometry of csrc/fused_head_sm90.cu: TH x TW = 8 x 16 low-res pixels per
# block; a ring entry stages one depth plane of CB channels (the volume's C
# padded to a multiple of 16 up to 64, one 32-channel group above); a box is
# [CB][SR+1][24] bf16 (the +-2 halo rounded up to whole 16-byte rows, one spare
# row), two in the ring, or two boxes [CB/2][SR][20] fp32 (one mbarrier each)
# a stage, up to two stages (below); the tap products P are fp32
# [27][(SR)(SW) + 4].
SM90_TILE_H, SM90_TILE_W, SM90_STAGES = 8, 16, 2
SM90_F32_MAX_STAGES = 2
SM90_SINGLE, SM90_GROUP = 64, 32  # one ring entry a plane up to 64 channels; 32-channel groups above
SMEM_PAIR_LIMIT = 115712  # the same with two blocks an SM: (233,472 - 2 x 1 KB reserved) / 2

# The C entries of the sm90 fused head (csrc/fused_head_sm90.cu): bf16, fp32.
HEAD_SM90_ENTRIES = ("lst_head_sm90_soft_argmin", "lst_head_sm90_f32_soft_argmin")
_SM90_BOX = 24 * (SM90_TILE_H + 5)
_SM90_F32_BOX = 20 * (SM90_TILE_H + 4)
_SM90_P = 27 * ((SM90_TILE_H + 4) * (SM90_TILE_W + 4) + 4)


def band_smem_bytes(d: int) -> int:
    """Shared memory of the band kernel: its fp32 cost tile [D][TH+2][TW+2]."""
    return 4 * d * (BAND_TILE_H + 2) * (BAND_TILE_W + 2)


def head_sm90_entry_channels(channels: int) -> int:
    """Channels one ring entry of the sm90 heads stages for a ``channels``-wide
    volume: ``channels`` rounded up to a multiple of 16 up to 64 (the padded
    channels read as zero), 32 (one channel group) above."""
    return -(-channels // 16) * 16 if channels <= SM90_SINGLE else SM90_GROUP


def head_sm90_smem_bytes(channels: int, d: int) -> int:
    """Shared memory of the bf16 sm90 fused head: the ring of
    two bf16 stages of the entry's channels, the tap products and the fp32
    cost tile [D][TH+2][TW+2], plus one mbarrier a stage."""
    cost = 4 * d * (SM90_TILE_H + 2) * (SM90_TILE_W + 2)
    return SM90_STAGES * (2 * head_sm90_entry_channels(channels) * _SM90_BOX + 8) + 4 * _SM90_P + cost


def _sm90_f32_fixed(d: int) -> int:
    return 4 * _SM90_P + 4 * d * (SM90_TILE_H + 2) * (SM90_TILE_W + 2)


def _sm90_f32_fit(entry: int, d: int, limit: int) -> int:
    fit = max(limit - _sm90_f32_fixed(d), 0) // (4 * entry * _SM90_F32_BOX + 16)
    return min(fit, SM90_F32_MAX_STAGES)


def head_sm90_f32_stages(channels: int, d: int) -> int:
    """Ring depth of the fp32 sm90 head: the fp32 stages of
    the entry's channels (each with its two mbarriers) that fit beside the tap
    products and the cost tile, at most two, within half an SM's shared
    memory for entries of at most 32 channels when one fits there (two blocks
    an SM), else within a whole block's limit; 0 when none fits."""
    entry = head_sm90_entry_channels(channels)
    if entry <= 32 and _sm90_f32_fit(entry, d, SMEM_PAIR_LIMIT) >= 1:
        return _sm90_f32_fit(entry, d, SMEM_PAIR_LIMIT)
    return _sm90_f32_fit(entry, d, SMEM_LIMIT)


def head_sm90_f32_smem_bytes(channels: int, d: int) -> int:
    """Shared memory of the fp32 sm90 fused head: its ring (at least one
    stage, each with two mbarriers), the tap products and the fp32 cost tile.
    Above ``SMEM_LIMIT`` exactly when no stage fits."""
    stages = max(head_sm90_f32_stages(channels, d), 1)
    return stages * (4 * head_sm90_entry_channels(channels) * _SM90_F32_BOX + 16) + _sm90_f32_fixed(d)


_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_LIB_NAME = "libleastereo_kernels.so"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

BUILD_DIR = _PKG / "build"

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {home}/bin or on PATH; the CUDA kernels cannot be built")
    return found


def _build(lib_path: pathlib.Path, sources: list[pathlib.Path]) -> None:
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename: concurrent first uses (test
    # workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
    os.close(fd)
    compile_flags = [f for f in _NVCC_FLAGS if f != "-shared"]
    pipe = {"stdout": subprocess.PIPE, "stderr": subprocess.STDOUT, "text": True}
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as objdir:
        # One nvcc a source, all started together, then one link.
        objs = [os.path.join(objdir, f"{src.stem}.o") for src in sources]
        procs = [subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", obj, str(src)], **pipe)
                 for src, obj in zip(sources, objs)]
        steps = [(proc.args, proc.communicate()[0], proc.returncode) for proc in procs]
        if all(rc == 0 for *_, rc in steps):
            link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs], **pipe)
            steps.append((link.args, link.stdout, link.returncode))
    (lib_path.parent / "nvcc.log").write_text("".join(" ".join(cmd) + "\n" + out for cmd, out, _ in steps))
    failed = [(cmd, out, rc) for cmd, out, rc in steps if rc != 0]
    if failed:
        os.unlink(tmp)
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out[-4000:]}")
    os.replace(tmp, lib_path)


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use; argument types declared."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    lib_path = BUILD_DIR / _LIB_NAME
    newest = max(s.stat().st_mtime for s in [*sources, *_CSRC.glob("*.cuh")])
    if not lib_path.exists() or lib_path.stat().st_mtime < newest:
        _build(lib_path, sources)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lst_error_string.argtypes = [i]
    lib.lst_error_string.restype = ctypes.c_char_p
    lib.lst_band_smem_bytes.argtypes = [i]
    lib.lst_band_smem_bytes.restype = ctypes.c_longlong
    lib.lst_band_blocks_per_sm.argtypes = [i]
    lib.lst_band_blocks_per_sm.restype = i
    lib.lst_band_soft_argmin.argtypes = [p, p, i, i, i, i, p]
    lib.lst_band_soft_argmin.restype = i
    lib.lst_head_sm90_smem_bytes.argtypes = [i, i]
    lib.lst_head_sm90_smem_bytes.restype = ctypes.c_longlong
    lib.lst_head_sm90_f32_smem_bytes.argtypes = [i, i]
    lib.lst_head_sm90_f32_smem_bytes.restype = ctypes.c_longlong
    lib.lst_head_sm90_f32_stages.argtypes = [i, i]
    lib.lst_head_sm90_f32_stages.restype = i
    for entry in HEAD_SM90_ENTRIES:
        getattr(lib, entry).argtypes = [p, p, p, i, i, i, i, i, i, p]
        getattr(lib, entry).restype = i
    # The gates decide with the formulas above: hold them to the built layout
    # (padded and grouped C, and D the deepest fp32 ring tests, included) so
    # a gate never admits a shape the kernel cannot launch.
    for c, d in ((16, 1), (32, 13), (32, 64), (32, 70), (64, 64), (32, 136), (64, 170), (32, 569),
                 (24, 64), (12, 64), (80, 64), (290, 64)):
        host = (band_smem_bytes(d), head_sm90_smem_bytes(c, d), head_sm90_f32_smem_bytes(c, d),
                head_sm90_f32_stages(c, d))
        built = (lib.lst_band_smem_bytes(d), lib.lst_head_sm90_smem_bytes(c, d), lib.lst_head_sm90_f32_smem_bytes(c, d),
                 lib.lst_head_sm90_f32_stages(c, d))
        if host != built:
            raise RuntimeError(f"shared memory (band, sm90 head, fp32 sm90 head and its stages) at C={c}, "
                               f"D={d}: library {built} != host {host}")
    _lib = lib
    return lib


# A TMA route's entry returns this + the CUresult of a refused tensor map.
TENSOR_MAP_ERROR = 100000


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` (or tensor-map ``CUresult``)
    returned by a launch."""
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed, CUresult {err - TENSOR_MAP_ERROR}")
    if err != 0:
        msg = load_kernels().lst_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
