"""Where the band kernel's time goes: the kernel timed with parts removed.

    python -m leastereo_tpu_torch.utils.band_breakdown [--csrc DIR] [--label NAME]

Builds variants of ``csrc/soft_argmin_heads.cu`` and its shared stage
``csrc/heads_common.cuh`` with ``nvcc`` (in parallel, each variant in its own
directory under ``leastereo_tpu_torch/build/band_breakdown/``), each with one
part of the band kernel taken out, and times each on the KITTI cost
``(1, 64, 128, 416)`` fp32. Outputs of the variants are meaningless; only
their times are read. Each variant runs in its own process. Prints one JSON
line per variant (with the band kernel's ptxas line), then the card line.
Needs one CUDA card; exits non-zero without one.

Variants: ``full``; ``no_exp`` (each exponential replaced by a cheap function
of its argument); ``no_pass1`` (the stage's min pass skipped); ``no_load``
(the cost tile not loaded); ``half_rows`` (``full`` on the top half of the
cost, one wave of blocks); ``tile_RxC`` (the band kernel on other tiles:
R x C low-res pixels, its resident blocks per SM capped as given), for
sources whose band kernel takes its tile from constants.

``--csrc`` points at another copy of the sources (an older commit's
``leastereo_tpu_torch/csrc``), so that two designs are timed in one call.
The markers below cover the stage before and after its one-exponential
redesign; a variant fails to build, and the script stops, when a source
matches none of them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

from ..ops import _build

_OUT = _build.BUILD_DIR / "band_breakdown"
SHAPE = (1, 64, 128, 416)  # (B, D, h, w)
_NEVER = "(D < 0)"  # never true, unknown to the compiler: nothing else is folded away

# (file, marker, replacement, count) per variant: the first `count` matches
# of each marker found are replaced (-1: all), and each variant needs one.
_EDITS = {
    "no_exp": [
        ("heads_common.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = 1.0f + 0.5f * x;", 1),
        ("heads_common.cuh", "__expf(", "(1.0f + 0.5f * ", -1),  # the three-exponential stage
    ],
    "no_pass1": [
        ("heads_common.cuh", "for (int d = 0; d < D; ++d, p += PLANE) {  // pass 1",
         f"for (int d = 0; d < D && {_NEVER}; ++d, p += PLANE) {{", 1),
        # the three-exponential stage: its first plane loop is pass 1 (m keeps plane 0's blends)
        ("heads_common.cuh", "  for (int d = 0; d < D; ++d) {\n    if (d + 1 < D) {\n      blend9",
         f"  for (int d = 0; d < D && {_NEVER}; ++d) {{\n    if (d + 1 < D) {{\n      blend9", 1),
    ],
    "no_load": [
        ("soft_argmin_heads.cu", "d < D; ++d) cp_async4(", f"d < D && {_NEVER}; ++d) cp_async4(", 1),
        ("soft_argmin_heads.cu", "idx < D * PLANE; idx += THREADS) {\n    const int d = idx / PLANE",
         f"idx < D * PLANE && {_NEVER}; idx += THREADS) {{\n    const int d = idx / PLANE", 1),
    ],
}


# Other band tiles: (rows, cols, resident blocks an SM), each a one-wave or
# near one-wave grid at KITTI with a warp on one tile row.
_TILES = {"tile_4x16": (4, 16, 7), "tile_2x32": (2, 32, 6)}
_TILE_CONSTS = re.compile(r"constexpr int BTH = \d+;(.*\n)constexpr int BTW = \d+;(.*\n)constexpr int BMIN_BLOCKS = \d+;")


def _variants(csrc: pathlib.Path) -> dict[str, dict[str, str]]:
    files = {n: (csrc / n).read_text() for n in ("soft_argmin_heads.cu", "heads_common.cuh")}
    out = {"full": files}
    for name, edits in _EDITS.items():
        texts, hits = dict(files), 0
        for fname, marker, repl, count in edits:
            if marker in texts[fname]:
                texts[fname] = texts[fname].replace(marker, repl, count)
                hits += 1
        if hits == 0:
            raise RuntimeError(f"variant {name}: the sources in {csrc} match none of its markers; update _EDITS")
        out[name] = texts
    if _TILE_CONSTS.search(files["soft_argmin_heads.cu"]):
        for name, (th, tw, blocks) in _TILES.items():
            text = _TILE_CONSTS.sub(
                rf"constexpr int BTH = {th};\1constexpr int BTW = {tw};\2constexpr int BMIN_BLOCKS = {blocks};",
                files["soft_argmin_heads.cu"])
            out[name] = {**files, "soft_argmin_heads.cu": text}
    return out


def _build_all(csrc: pathlib.Path, label: str) -> dict[str, str]:
    procs = {}
    for name, texts in _variants(csrc).items():
        d = _OUT / label / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        cmd = [_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "soft_argmin_heads.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-3000:]}")
        # ptxas prints "Compiling entry function '<mangled band_kernel>'" then its usage lines.
        m = re.search(r"entry function '[^']*band_kernel[^\n]*\n((?:[^\n]*\n)*?[^\n]*Used [^\n]*)", log)
        ptxas[name] = " ".join(ln.strip() for ln in m.group(1).splitlines() if "spill" in ln or "Used" in ln) if m else None
    return ptxas


def _time_variant(lib_path: str, rows: int) -> float:
    import torch

    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lst_band_soft_argmin.argtypes = [p, p, i, i, i, i, p]
    lib.lst_band_soft_argmin.restype = i
    b, d, _, w = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    cost = torch.randn(b, d, rows, w, generator=gen, device="cuda")
    out = torch.empty(b, 3 * rows, 3 * w, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.lst_band_soft_argmin(cost.data_ptr(), out.data_ptr(), b, d, rows, w, stream)
        if err != 0:
            raise RuntimeError(f"{lib_path}: CUDA error {err}")

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        launch()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 200


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--time":  # one variant, in its own process
        print(json.dumps({"ms": _time_variant(sys.argv[2], int(sys.argv[3]))}), flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=pathlib.Path, default=_build._CSRC, help="directory of the kernel sources")
    ap.add_argument("--label", default="tree", help="name of this set of sources in the output")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("band_breakdown: no CUDA device", file=sys.stderr)
        return 2
    ptxas = _build_all(args.csrc.resolve(), args.label)
    h = SHAPE[2]
    runs = [(name, name, h) for name in ptxas] + [("half_rows", "full", h // 2)]
    for variant, lib_name, rows in runs:
        lib_path = str(_OUT / args.label / lib_name / "lib.so")
        proc = subprocess.run([sys.executable, "-m", __spec__.name, "--time", lib_path, str(rows)],
                              capture_output=True, text=True, timeout=300, check=True)
        res = {"sources": args.label, "variant": variant, "shape": [SHAPE[0], SHAPE[1], rows, SHAPE[3]],
               **json.loads(proc.stdout), "ptxas_band_kernel": ptxas[lib_name]}
        print(json.dumps(res), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
