"""Where the sm90 fused head's time goes: the kernel timed with parts removed.

    python -m leastereo_tpu_torch.utils.head_sm90_breakdown

Builds variants of ``csrc/fused_head_sm90.cu`` with ``nvcc`` (in parallel,
into ``leastereo_tpu_torch/build/breakdown/``), each with one part of the
kernel taken out, and times each at the KITTI head shape, bf16 volume
``(1, 32, 64, 128, 416)``, with bf16 and with fp32 weights. Outputs of the
variants are meaningless; only their times are read. Each variant runs in its
own process. Prints one JSON line per variant, then the card line. Needs one
CUDA card; exits non-zero without one.

Variants: ``full``; ``no_softmin`` (the shared upsample/softmin stage
skipped); ``no_tap_sum``; ``no_contraction`` (no ``ldmatrix``, no ``mma``);
``no_tma`` (no loads and no waits: the kernel's work without memory);
``loop_no_compute`` (only the TMA ring and barriers of the plane loop).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

from ..ops import _build

_SRC = _build._CSRC / "fused_head_sm90.cu"
_OUT = _build.BUILD_DIR / "breakdown"
SHAPE = (1, 32, 64, 128, 416)  # (B, C, D, h, w)

_SOFTMIN = "  heads::upsample_softmin_store<TH, TW, THREADS>("
_TAP_SUM = "    if (owner) {\n      float q[3];"
_MT_LOOP = "    for (int mt = warp; mt < MTILES; mt += WARPS) {"
_WAIT = "    mbar_wait(smem_u32(&full[s]), (din / STAGES) & 1);"
_LOAD_FIRST = "  if (tid == 0) {\n    for (int s = 0; s < STAGES && s < D; ++s)"
_LOAD_NEXT = "    if (tid == 0 && din + STAGES < D) {"


def _variants(src: str) -> dict[str, str]:
    for part in (_SOFTMIN, _TAP_SUM, _MT_LOOP, _WAIT, _LOAD_FIRST, _LOAD_NEXT):
        if part not in src:
            raise RuntimeError(f"fused_head_sm90.cu no longer contains {part!r}; update the variants")
    # `D < 0` is never true but unknown to the compiler, so nothing else is folded away.
    no_softmin = src.replace(_SOFTMIN, "  if (D < 0) " + _SOFTMIN.lstrip())
    no_tap_sum = src.replace(_TAP_SUM, "    if (D < 0) {\n      float q[3];")
    no_contraction = src.replace(_MT_LOOP, "    for (int mt = warp; mt < (D < 0 ? MTILES : 0); mt += WARPS) {")
    no_tma = (
        src.replace(_WAIT, "")
        .replace(_LOAD_FIRST, "  if (D < 0) {\n    for (int s = 0; s < STAGES && s < D; ++s)")
        .replace(_LOAD_NEXT, "    if (D < 0) {")
    )
    loop_no_compute = (
        no_contraction.replace(_SOFTMIN, "  if (D < 0) " + _SOFTMIN.lstrip()).replace(_TAP_SUM, "    if (D < 0) {\n      float q[3];")
    )
    return {
        "full": src,
        "no_softmin": no_softmin,
        "no_tap_sum": no_tap_sum,
        "no_contraction": no_contraction,
        "no_tma": no_tma,
        "loop_no_compute": loop_no_compute,
    }


def _build_all() -> list[str]:
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in _variants(_SRC.read_text()).items():
        cu = _OUT / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build._NVCC_FLAGS, "-I", str(_build._CSRC), "-o", str(_OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-3000:]}")
    return list(procs)


def _time_variant(name: str) -> dict:
    import torch

    lib = ctypes.CDLL(str(_OUT / f"{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lst_head_sm90_soft_argmin.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.lst_head_sm90_soft_argmin.restype = i
    b, c, d, h, w = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    vol = torch.randn(b, c, d, h, w, generator=gen, device="cuda").to(torch.bfloat16)
    k32 = 0.2 * torch.randn(1, c, 3, 3, 3, generator=gen, device="cuda")
    out = torch.empty(b, 3 * h, 3 * w, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {"variant": name}
    for label, kern in (("bf16_weights_ms", k32.to(torch.bfloat16).float()), ("fp32_weights_ms", k32)):
        def launch():
            err = lib.lst_head_sm90_soft_argmin(vol.data_ptr(), kern.data_ptr(), out.data_ptr(), b, c, d, h, w, stream)
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
    if len(sys.argv) == 2:  # one variant, in its own process
        print(json.dumps(_time_variant(sys.argv[1])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("head_sm90_breakdown: no CUDA device", file=sys.stderr)
        return 2
    names = _build_all()
    for name in names:
        proc = subprocess.run(
            [sys.executable, "-m", __spec__.name, name], capture_output=True, text=True, timeout=300, check=True
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
