"""The fused head's routes timed against the kernel library of an older commit.

    python -m leastereo_tpu_torch.utils.head_routes_bench PARENT_CSRC OLDER_HEAD

``PARENT_CSRC`` is the older commit's ``leastereo_tpu_torch/csrc`` (unpacked
with ``git archive <commit> leastereo_tpu_torch/csrc``), built with ``nvcc``
into ``leastereo_tpu_torch/build/head_routes/``; ``OLDER_HEAD`` names a C
entry of it that computes the fused head for any channel count and width,
taking ``(vol, vol_is_bf16, kern, out, B, C, D, h, w, stream)``: the fused
head design the routes replaced. Everything is timed in turns on the one
card, best of the turns (CUDA events, 50 calls a turn; 200 at KITTI):

* ``kitti``: the main path's KITTI volume ``(1, 32, 64, 128, 416)`` through
  the bf16 head (fp32 and bf16 weights) and the fp32 head, read in place,
  older library against this tree's: older, tree, tree, older.
* ``shape``: each volume of ``kernel_parity.ROUTE_SHAPES`` through the route
  this tree gives it (its wrapper, so a repitch route's copy counts), the
  older library's ``OLDER_HEAD`` and the two-call yardstick (cuDNN
  ``last_3`` in the volume's type, TF32 off, then the band kernel): route,
  first design, yardstick, yardstick, first design, route; with the route's
  error against float64 on the diffuse input.
* ``sass``: each library's C = 32 kernels, bf16 and fp32, their instruction
  counts and the opcodes whose counts differ.

Prints one JSON line a measurement, then the card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

from ..ops import _build

_OUT = _build.BUILD_DIR / "head_routes"
KITTI = (1, 32, 64, 128, 416)
MAXDISP = 192
ITERS = 50


def _build_older(csrc: pathlib.Path) -> pathlib.Path:
    """nvcc each ``*.cu`` of ``csrc`` (all started together), linked into one library."""
    shutil.rmtree(_OUT, ignore_errors=True)
    _OUT.mkdir(parents=True)
    flags = [f for f in _build._NVCC_FLAGS if f != "-shared"]
    procs = [(_OUT / f"{src.stem}.o", subprocess.Popen([_build._nvcc(), *flags, "-c", "-o", str(_OUT / f"{src.stem}.o"),
                                                          str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                         text=True))
             for src in sorted(csrc.glob("*.cu"))]
    for obj, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.stem}:\n{log[-3000:]}")
    lib = _OUT / "older.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib), *[str(o) for o, _ in procs]], check=True)
    return lib


def _ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _turns(fns: dict, order: list[str], iters: int) -> dict:
    times = collections.defaultdict(list)
    for key in order:
        times[key].append(_ms(fns[key], iters))
    return {k: {"ms": min(v), "turns_ms": v} for k, v in times.items()}


def kitti_lines(older: ctypes.CDLL, tree: ctypes.CDLL) -> list[dict]:
    import torch

    p, i = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, c, d, h, w = KITTI
    vol32 = 0.5 * torch.randn(b, c, d, h, w, generator=gen, device="cuda")
    kern = 0.2 * torch.randn(1, c, 3, 3, 3, generator=gen, device="cuda")
    out = torch.empty(b, 3 * h, 3 * w, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for name, vol, k32 in (("bf16_volume_fp32_weights", vol32.bfloat16(), kern),
                           ("bf16_volume_bf16_weights", vol32.bfloat16(), kern.bfloat16().float()),
                           ("fp32_volume", vol32, kern)):
        entry = _build.HEAD_SM90_ENTRIES[vol.dtype == torch.float32]
        fo, ft = getattr(older, entry), getattr(tree, entry)
        fo.argtypes, fo.restype = [p, p, p, i, i, i, i, i, p], i
        args = (vol.data_ptr(), k32.data_ptr(), out.data_ptr(), b, c, d, h, w)
        fns = {"older": lambda: _build.check(fo(*args, stream), "older"),
               "tree": lambda: _build.check(ft(*args, w, stream), "tree")}
        t = _turns(fns, ["older", "tree", "tree", "older"], 4 * ITERS)
        lines.append({"phase": "kitti", "name": name, "older": t["older"], "tree": t["tree"],
                      "tree_over_older": t["tree"]["ms"] / t["older"]["ms"]})
    return lines


def shape_lines(older: ctypes.CDLL, older_head: str) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from ..ops.fused_head import ROUTE_WRAPPERS, conv_soft_argmin_reference, fused_head_route
    from ..ops.fused_softargmin import soft_argmin_cuda
    from .kernel_parity import ROUTE_SHAPES, head_inputs, offset_copy

    p, i = ctypes.c_void_p, ctypes.c_int
    first = getattr(older, older_head)
    first.argtypes, first.restype = [p, i, p, p, i, i, i, i, i, p], i
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for name, (shape, dtype_name, offset) in ROUTE_SHAPES.items():
        dtype = getattr(torch, dtype_name)
        b, c, d, h, w = shape
        vol32, kern = head_inputs(gen, "diffuse", b, c, d, h, w, "cuda")
        vol = offset_copy(vol32.to(dtype), offset)
        del vol32
        kern_t = kern.to(dtype)
        out = torch.empty(b, 3 * h, 3 * w, device="cuda")
        route = fused_head_route(c, d, w, MAXDISP, dtype, aligned=vol.data_ptr() % 16 == 0)
        wrapper = ROUTE_WRAPPERS[route]
        fns = {"route": lambda: wrapper(vol, kern, MAXDISP),
               "first_design": lambda: _build.check(first(vol.data_ptr(), int(dtype == torch.bfloat16), kern.data_ptr(),
                                                          out.data_ptr(), b, c, d, h, w, stream), "first design"),
               "yardstick": lambda: soft_argmin_cuda(F.conv3d(vol, kern_t, padding=1)[:, 0].float(), MAXDISP)}
        ref = conv_soft_argmin_reference(vol.double(), kern.double(), MAXDISP)
        err = (wrapper(vol, kern, MAXDISP).double() - ref).abs().max().item()
        del ref
        t = _turns(fns, ["route", "first_design", "yardstick", "yardstick", "first_design", "route"], ITERS)
        lines.append({"phase": "shape", "name": name, "shape": list(shape), "dtype": dtype_name, "offset_bytes": offset,
                      "route": route, **{f"{k}_ms": v["ms"] for k, v in t.items()}, "turns": t,
                      "max_abs_err_px_diffuse": err})
        del vol, out
        torch.cuda.empty_cache()
    return lines


def _opcodes(lib: pathlib.Path, kernel: str) -> collections.Counter:
    """Opcode counts of the one C = 32 instantiation of ``kernel`` in ``lib``:
    ``<kernel>ILi2EE`` in older libraries, ``<kernel>ILi2ELb0EE`` (not grouped)
    in this tree's."""
    cuobjdump = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    parts = [part for part in text.split("Function : ")[1:]
             if re.search(rf"{kernel}ILi2E(?:Lb0E)?E", part.split("\n", 1)[0])]
    if len(parts) != 1:
        raise RuntimeError(f"{lib}: {len(parts)} C = 32 instantiations of {kernel}")
    return collections.Counter(re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", parts[0]))


def sass_lines(older: pathlib.Path, tree: pathlib.Path) -> list[dict]:
    lines = []
    for kernel in ("head_sm90_kernel", "head_sm90_f32_kernel"):
        a, b = _opcodes(older, kernel), _opcodes(tree, kernel)
        lines.append({"phase": "sass", "kernel": kernel, "instructions": {"older": sum(a.values()), "tree": sum(b.values())},
                      "opcode_counts_that_differ": {op: [a[op], b[op]] for op in sorted(set(a) | set(b)) if a[op] != b[op]}})
    return lines


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("head_routes_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = _build.load_kernels()
    older_path = _build_older(pathlib.Path(args[0]).resolve())
    older = ctypes.CDLL(str(older_path))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for line in [*kitti_lines(older, tree), *shape_lines(older, args[1]),
                 *sass_lines(older_path, _build.BUILD_DIR / _build._LIB_NAME)]:
        print(json.dumps({**line, "card": card}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
