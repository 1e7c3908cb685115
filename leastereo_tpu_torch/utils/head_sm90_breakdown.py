"""Where the sm90 fused head's time goes: the kernel timed with parts removed.

    python -m leastereo_tpu_torch.utils.head_sm90_breakdown [--dtype float32]

Builds variants of ``csrc/fused_head_sm90.cu`` with ``nvcc`` (in parallel,
into ``leastereo_tpu_torch/build/breakdown/``), each with one part of the
kernel taken out, and times each at the KITTI head shape ``(1, 32, 64, 128,
416)``: the bf16 kernel on a bf16 volume (the default), or the fp32 kernel
on an fp32 volume (``--dtype float32``), each with tf32-exact (bf16-rounded)
and with fp32 weights. Outputs of the variants are meaningless; only their
times are read. Each variant runs in its own process. Prints one JSON line
per variant, then the card line. Needs one CUDA card; exits non-zero
without one.

Variants: ``full``; ``no_softmin`` (the shared upsample/softmin stage
skipped); ``no_tap_sum``; ``no_contraction`` (no fragment loads, no
``mma``; the fp32 kernel still stores its zero tap products); ``no_tma``
(no loads and no waits: the kernel's work without memory);
``loop_no_compute`` (only the TMA ring and barriers of the plane loop). With ``--dtype float32`` also ``one_block_two_stages`` (one block
an SM with a two-stage ring, where the kernel runs two blocks with one
stage each), ``box_rows_14`` (two spare box rows: 14% more bytes staged, no
bank conflicts on the A loads), ``l2_promotion_256`` (the tensor
map's L2 promotion at 256 B) and ``ring_one_box`` (``loop_no_compute`` with
every block reading one box, so its reads hit L2). ``--csrc`` points at
another copy of the sources (an older commit's ``leastereo_tpu_torch/csrc``),
so two designs are timed in one call; ``--only`` names the variants to run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

from ..ops import _build

_OUT = _build.BUILD_DIR / "breakdown"
SHAPE = (1, 32, 64, 128, 416)  # (B, C, D, h, w)

_SOFTMIN = "  heads::upsample_softmin_store<TH, TW, THREADS>("
_TAP_SUM = "    if (owner) {\n      float q[3];"
_MT_LOOP = "for (int mt = warp; mt < MT; mt += "  # bf16: the contraction's loop over row tiles
_F32_MT = "if (mt >= MT) break;  // warp-uniform"  # fp32: the same
_WAIT = "    mbar_wait(smem_u32(&full[s]), (din / stages) & 1);"
_F32_WAIT = "        mbar_wait(smem_u32(&full[2 * s + hh]), (din / stages) & 1);"
_LOAD_FIRST = "  if (tid == 0) {\n    for (int s = 0; s < stages && s < D; ++s)"
_LOAD_NEXT = "    if (tid == 0 && din + stages < D) {"
_F32_ROWS = "  static constexpr int BH = SR;"
_F32_PAIR = "constexpr size_t PAIR_LIMIT = 115712;"
_F32_BOUNDS = (
    "template <int KS>  // two blocks per SM up to C = 32 (registers capped at 128), as in bf16\n"
    "__global__ void __launch_bounds__(THREADS, KS <= 2 ? 2 : 1)"
)
_L2_PROMOTION = "CU_TENSOR_MAP_L2_PROMOTION_L2_128B"
_BOX_START = "j0 - 2, i0 - 2, "


def _edit(src: str, *pairs: tuple[str, str]) -> str:
    """``src`` with each ``(old, new)`` replaced; raises when ``old`` is missing."""
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"fused_head_sm90.cu no longer contains {old!r}; update the variants")
        src = src.replace(old, new)
    return src


# `D < 0` is never true but unknown to the compiler, so nothing else is folded away.
_NO_SOFTMIN = (_SOFTMIN, "  if (D < 0) " + _SOFTMIN.lstrip())
_NO_TAP_SUM = (_TAP_SUM, "    if (D < 0) {\n      float q[3];")
_NO_CONTRACTION = ((_MT_LOOP, "for (int mt = warp; mt < (D < 0 ? MT : 0); mt += "),
                   (_F32_MT, "if (mt >= (D < 0 ? MT : 0)) break;  // warp-uniform"))
_NO_LOADS = ((_WAIT, ""), (_F32_WAIT, ""),
             (_LOAD_FIRST, "  if (D < 0) {\n    for (int s = 0; s < stages && s < D; ++s)"),
             (_LOAD_NEXT, "    if (D < 0) {"))
_LOOP_ONLY = (*_NO_CONTRACTION, _NO_SOFTMIN, _NO_TAP_SUM)

# name -> (the replacements, fp32 only)
VARIANTS = {
    "full": ((), False),
    "no_softmin": ((_NO_SOFTMIN,), False),
    "no_tap_sum": ((_NO_TAP_SUM,), False),
    "no_contraction": (_NO_CONTRACTION, False),
    "no_tma": (_NO_LOADS, False),
    "loop_no_compute": (_LOOP_ONLY, False),
    # One block an SM with a two-stage ring (133,888 B at C = 32, D = 64),
    # the layout the fp32 kernel takes when half an SM holds no stage.
    "one_block_two_stages": (((_F32_PAIR, "constexpr size_t PAIR_LIMIT = 0;"),
                              (_F32_BOUNDS, _F32_BOUNDS.replace("KS <= 2 ? 2 : 1)", "1)"))), True),
    "box_rows_14": (((_F32_ROWS, "  static constexpr int BH = SR + 2;"),), True),
    "l2_promotion_256": (((_L2_PROMOTION, "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"),), True),
    # The ring alone with every block reading the box at (0, 0): all but the
    # first reads hit L2, so its time against loop_no_compute's says how much
    # of the ring is the volume's DRAM traffic.
    "ring_one_box": ((*_LOOP_ONLY, (_BOX_START, "0, 0, ")), True),
}


def _variants(src: str, fp32: bool, only: list[str] | None = None) -> dict[str, str]:
    return {name: _edit(src, *pairs) for name, (pairs, fp32_only) in VARIANTS.items()
            if (fp32 or not fp32_only) and (not only or name in only)}


def _build_all(csrc: pathlib.Path, label: str, fp32: bool, only: list[str] | None) -> list[str]:
    out = _OUT / label
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in _variants((csrc / "fused_head_sm90.cu").read_text(), fp32, only).items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build._NVCC_FLAGS, "-I", str(csrc), "-o", str(out / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-3000:]}")
    return list(procs)


def _time_variant(label: str, name: str, fp32: bool) -> dict:
    import torch

    lib = ctypes.CDLL(str(_OUT / label / f"{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    entry = lib.lst_head_sm90_f32_soft_argmin if fp32 else lib.lst_head_sm90_soft_argmin
    entry.argtypes = [p, p, p, i, i, i, i, i, p]
    entry.restype = i
    b, c, d, h, w = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    vol = torch.randn(b, c, d, h, w, generator=gen, device="cuda").to(torch.float32 if fp32 else torch.bfloat16)
    k32 = 0.2 * torch.randn(1, c, 3, 3, 3, generator=gen, device="cuda")
    out = torch.empty(b, 3 * h, 3 * w, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {"sources": label, "variant": name, "volume": str(vol.dtype)}
    if fp32:
        lib.lst_head_sm90_f32_stages.argtypes = [i, i]
        res["stages"] = lib.lst_head_sm90_f32_stages(c, d)
    for label, kern in (("bf16_weights_ms", k32.to(torch.bfloat16).float()), ("fp32_weights_ms", k32)):
        def launch():
            err = entry(vol.data_ptr(), kern.data_ptr(), out.data_ptr(), b, c, d, h, w, stream)
            _build.check(err, f"variant {name}")

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            launch()
        stop.record()
        stop.synchronize()
        res[label] = start.elapsed_time(stop) / 50
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16", help="volume type")
    parser.add_argument("--csrc", type=pathlib.Path, default=_build._CSRC, help="directory of the kernel sources")
    parser.add_argument("--label", default="tree", help="name of this set of sources in the output")
    parser.add_argument("--only", nargs="+", help="build and time only these variants")
    parser.add_argument("--variant", help=argparse.SUPPRESS)  # one built variant, in its own process
    args = parser.parse_args()
    fp32 = args.dtype == "float32"
    if args.variant:
        print(json.dumps(_time_variant(args.label, args.variant, fp32)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("head_sm90_breakdown: no CUDA device", file=sys.stderr)
        return 2
    names = _build_all(args.csrc.resolve(), args.label, fp32, args.only)
    for name in names:
        proc = subprocess.run(
            [sys.executable, "-m", __spec__.name, "--dtype", args.dtype, "--label", args.label, "--variant", name],
            capture_output=True, text=True, timeout=300, check=True,
        )
        print(proc.stdout.strip(), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"shape": SHAPE, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
