#!/usr/bin/env python3
"""Drive the PyTorch port (leastereo_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

It holds the kernels' times alone and the runs of the paths that no
benchmark cell exercises. A frame's or a step's rate and the per-layer
times of the benchmark's cells are ``benchmark/``'s; a frame's route and
launch counts are ``tests/test_torch_cuda.py``'s.

Phases, each printing one JSON line and raising on failure (nothing is
caught, so any failure exits non-zero):

1. card: name and power limit (nvidia-smi); TF32 off for the fp32 phases.
2. build: the CUDA kernels built from leastereo_tpu_torch/csrc with nvcc.
3. kernels: each kernel on the card at the KITTI main-path shapes against
   its plain PyTorch version evaluated in float64, on peaky (trained-like),
   wide (the peaky cost scaled 10x, a span of hundreds of units) and
   diffuse inputs (the checks of ``leastereo_tpu_torch/utils/kernel_parity.py``):
   each route of the fused head (the in-place routes on a bf16 and an fp32
   volume, the repitch routes on the same volumes 4 bytes past a 16-byte
   boundary) and the band kernel; the band kernel and both TMA heads on a
   300x cost beside the fp32 plain version, all against float64 (a
   measurement: there fp32 rounding of the cost alone moves the result by
   ~3e-3 px); then the TMA heads' times in turns with their unfused
   yardsticks (cuDNN ``last_3`` in the volume's type, TF32 off, + band
   kernel), each head at least twice as fast as its yardstick, the band
   kernel's time, grid and occupancy; the route shapes
   (``utils/kernel_parity.ROUTE_SHAPES``: padded and grouped channels,
   widths TMA cannot read in place, an unaligned base), each launching its
   route once and within 2e-3 px of float64 on the three kinds of input,
   timed in turns with its yardstick; where the body's time goes: padded
   channels (C = 24 against 32) and the repitch copy (the repitch routes
   forced on the volumes the in-place routes read); and the matching net's
   3x3x3 convolution classes at a Middlebury and a KITTI frame's shapes:
   the sm90 kernel within one bf16 rounding, timed beside cuDNN.
4. main path: ``best_sceneflow_model`` at KITTI 384x1248, maxdisp 192, bf16,
   eval, random seeded weights: the in-model fused path of
   ``kernel_parity`` (the model's map against float64 on the volume and
   kernel it hands its head, the ``last_3`` kernel as calibrated, 10x and
   0.1x); the ``return_entropy`` forward (one band-kernel launch and no
   other head's; counts zeroed just before, read just after); then one
   frame at KITTI and one at Middlebury (1008x1512, maxdisp 408, bf16) in
   which every call of an NDHWC kernel (``csrc/ndhwc.cu``: stem, concat,
   resize; 1, 14 and 17 a frame) is held bit for bit against its plain
   version on the same input (the stem against the fused stem's NCDHW
   PyTorch gathers, the concat against ``torch.cat``, the resize, the last
   one written NCDHW, against ``F.interpolate``), each timed beside it.
5. profile: the device time of three KITTI bf16 frames by kernel kind
   (the class table of PERF.md section 5) and the launches of the kernel
   table; four fp32 KITTI frames' device time and the fp32 sm90 head's
   share of it (one launch a frame, no other head's; counts zeroed just
   before, read just after).
6. whole model, kernel path against plain path, fp32, 96x192, maxdisp 48
   (the fp32 sm90 head and the band kernel; counts zeroed just before and
   read just after); then the same with a 24-channel matching net
   (``mat_filter_multiplier`` 6), whose volume the fp32 TMA route takes with
   its channels padded to 32 (one launch, none of the other heads); then the
   op ``torch.ops.leastereo.conv_soft_argmin`` on volumes TMA cannot read in
   place (bf16 w = 412, bf16 at +4 bytes, fp32 w = 414; a model's volume
   never is one): the repitch routes, 2 and 1 launches, each within 2e-3 px of
   float64.
7. gate refusal: a cost the band kernel refuses raises on the card.
8. cli: the predict and evaluate drivers (``leastereo_tpu_torch.cli``)
   called in-process on the bundled KITTI frames (``dataset/kitti15_part``)
   at 384x1248, maxdisp 192, with phase 4's weights saved as a torch file
   and given as ``--checkpoint``, writing into a temporary directory:
   evaluate on the 4 ``train`` frames by default (sm90 head), with
   ``--confidence`` (band kernel) and with ``--dtype float32`` (the fp32
   sm90 head), then predict on the ``test`` frame, then evaluate
   ``--full_frame`` under the fine-tune crop 288x576 (each 324x576 frame
   padded whole to 336x576, ``BEST_SCENEFLOW``'s multiple of 24). Each run's
   outputs, metrics and launch counts (zeroed just before, read just after:
   one launch of its head per frame, none of the others) are checked, and
   frame 0 of the default and the ``--full_frame`` run is held against
   phase 4's model called directly on the same padded input; the sm90 head
   at the ``--full_frame`` run's volume, (1, 32, 64, 112, 192) bf16, is held
   against its plain version in float64 and timed.
9. export: ``python -m leastereo_tpu_torch.cli.export`` of phase 4's weights
   at 384x1248 (bf16) and of phase 6's at 96x192 (fp32, maxdisp 48), each
   passing its round-trip check; each ``.pt2`` loaded here and run with the
   counts zeroed just before (10 KITTI frames: one sm90 head each and nothing
   else; 3 fp32 frames: one fp32 sm90 head each), within 1e-3 px of the
   eager model, its frame times beside the eager model's; a
   ``utils.tracing.trace`` of one loaded frame of each program must name its
   kernel (``head_sm90_kernel``, ``head_sm90_f32_kernel``);
   ``utils.profiling.model_flops`` of a KITTI bf16 frame, equal with the head
   unfused, and the phase's peak memory.
10. train: the band kernel at the train forward's cost (4, 64, 96, 192),
   peaky and diffuse, forward and gradient against float64; the sm90 head
   at each val frame's volume (1, 32, 64, 96, 192) bf16, peaky, wide and
   diffuse, against float64; one train step
   (fp32, TF32 off, 96x192, maxdisp 48, batch 2) of the kernel path against
   the plain path, loss and per-tensor gradients; then
   ``leastereo_tpu_torch.cli.train.main`` in-process on the KITTI fine-tune
   recipe (288x576, batch 4, maxdisp 192, bf16, Adam, 31 epochs of one step
   on the 4 bundled train frames, one val frame each) with the plain head
   barred from the model: every logged loss finite, step 31's below half of
   step 1's, one band-kernel launch per train step and one sm90-head launch
   per val frame (counts zeroed just before, read just after), ``best`` and
   ``final`` written, ``final`` loading into ``evaluate``, a run resumed
   from ``best`` starting below the cold run's first loss.
11. search: the band kernel at the search cost (2, 64, 64, 128), peaky,
   wide and diffuse, against float64; one supernet weight step's gradients
   (fp32, TF32 off, 96x192, maxdisp 48, 6-layer/12-layer filter-4 block-3
   step-3 nets) of the kernel path against the plain path, loss and
   per-tensor gradients, and of remat on against off, loss, gradients and
   running statistics; then ``leastereo_tpu_torch.cli.search.main``
   in-process on the reference search (``scripts/search.sh``: 192x384,
   maxdisp 192, bf16, 10 epochs, arch steps from epoch 3, lr 0.025 to
   0.001, arch lr 0.001; batch 2, since each bundled ``sceneflow_part``
   search list holds 2 frames): every weight step's loss finite, the betas
   unchanged through epoch 2 and moving every epoch after, ``best``
   written, and exactly 27 band-kernel launches (10 weight steps, 7 arch
   steps, 10 val frames; counts zeroed just before, read just after) and no
   fused-head launch; then ``cli.decode.main`` on ``best`` (legal trellis
   walks) and the decoded network at the serving width (filter 8, block 4)
   on one KITTI 384x1248 bf16 frame: finite, exactly one sm90 launch.
   Prints the median weight-step and arch-step ms (steps 3 on), the val
   frame ms, the run's peak memory and the phase's seconds, and from one
   profiled weight step the device time by kernel kind, the kernels
   launched and the device's idle share.
12. parallel: (a) the disparity-sharded KITTI frame (384x1248, full width)
   on two processes of the one card over gloo with CUDA tensors, in fp32
   (TF32 off) at maxdisp 192 and 408, each within 1e-3 px of the
   one-process frame with the plain head (its volumes NDHWC; the gap to
   the same frame with its volumes kept NCDHW printed beside it), and no
   further from the same model's float64 frame than the one-process fp32
   frame is (plus 1e-3 px), then in bf16 (finite; ms a frame,
   the collectives' ms a frame, each rank's peak memory), with no head
   kernel launched (counts zeroed just before, read just after); (b) three
   data-parallel SGD steps of the fine-tune shapes (288x576, global batch
   4, fp32, TF32 off) on the two ranks against one process on the same
   global batches (step 1's loss to 1e-4; gradients and later losses within
   2x the fp32 noise floor that the same run with its rows reordered
   shows), the band kernel once per step on each rank; (c) ``cli.train
   --multihost`` at world size 1 over NCCL (NCCL refuses two ranks on one
   device, so this is all of NCCL one card can show): 3 steps, the band
   kernel once per step, the sm90 head once per val frame, the checkpoint
   written; (d) disparity-sharded training, the Middlebury fine-tune of
   ``scripts/train_md.sh`` (full width, 384x576 crops, maxdisp 408, batch 2,
   seeded synthetic batches) on the two ranks over a data 1 x disp 2 mesh:
   three fp32 SGD steps (TF32 off) against one process on the same global
   batches, with the bounds of (b); eight bf16 Adam steps timed (median
   step ms from step 2, the last step's all_reduces clocked by the layer
   that called them, each rank's peak memory) beside four in one process;
   no head kernel launched in any sharded step (counts zeroed just before,
   read just after), as JAX gates its kernels off under a pspec. The phase
   starts its ranks as ``chip_smoke.py --rank ...``.

Then the kernel table, the card line and, last, the result line. Exits
non-zero without printing a result when no CUDA card is present.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from leastereo_tpu_torch.utils import kernel_parity
from leastereo_tpu_torch.utils.kernel_parity import WIDE, calibrate_head, head_inputs, peaky_cost

# Published H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s,
# bf16 tensor cores 989 TFLOP/s, fp32 CUDA cores 67 TFLOP/s. Special-function
# units (exp2): 16 results per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# 1.98 GHz boost clock. The heads need one exponential per low-res plane
# and output phase: 9 D per low-res pixel.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_SFU_S = 16 * 132 * 1.98e9

# Kernel-name patterns for the per-frame device-time breakdown (first match wins).
KERNEL_GROUPS = (
    ("head kernels (this port)", ("head_sm90_kernel", "head_sm90_f32_kernel", "band_kernel")),
    ("3x3x3 convolutions (this port)", ("conv3d_sm90_kernel",)),
    ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions (cuDNN)", ("xmma", "implicit_gemm", "conv", "cudnn", "gemm", "sm90_", "sm80_")),
    ("trilinear/bilinear resize", ("upsample",)),
    ("gathers (fused stem)", ("index", "gather")),
    ("elementwise (add, relu, cast, cat)", ("elementwise", "CatArray", "reduce")),
)
TOL_KERNEL_PX = kernel_parity.ATOL_PX  # kernels against float64 plain versions
SRC_SM90 = "leastereo_tpu_torch/csrc/fused_head_sm90.cu"
SRC_HEADS = "leastereo_tpu_torch/csrc/soft_argmin_heads.cu"
SRC_NDHWC = "leastereo_tpu_torch/csrc/ndhwc.cu"
SRC_CONV3D = "leastereo_tpu_torch/csrc/conv3d_sm90.cu"
MD_FRAME = (1008, 1512, 408)  # a Middlebury frame (predict_md.sh): H, W, maxdisp
# The NDHWC kernels' calls a frame.
NDHWC_CALLS = {"stem_ndhwc": 1, "cat_ndhwc": 14, "resize_ndhwc": 17}
# The matching net's 3x3x3 convolutions by class, (frame, C_in, C_out, (D, H,
# W), calls a frame): the skips, the level-1 cells, the stem, the level-0
# cell, the level-2 cells.
CONV3D_CLASSES = [(frame, *c) for frame, dhw in (("middlebury", (136, 336, 504)), ("kitti", (64, 128, 416)))
                  for c in ((128, 64, tuple(n // 2 for n in dhw), 2), (16, 16, tuple(n // 2 for n in dhw), 36),
                            (32, 32, dhw, 1), (8, 8, dhw, 6), (32, 32, tuple(n // 4 for n in dhw), 30))]
TOL_MODEL_PX = 2e-3  # whole model, kernel path against plain path, fp32
TOL_CLI_PX = 2e-3  # the evaluate driver's frame 0 against the model called directly
TOL_EXPORT_PX = 1e-3  # a loaded .pt2 program against the eager model (the driver's own round-trip bound)
EXPORT_FRAMES, EXPORT_FP32_FRAMES = 10, 3  # frames of the loaded KITTI bf16 and fp32 programs
# Phase 10, training. The KITTI fine-tune recipe (run/kitti_ft_r05/README.md:15-19):
# 288x576 crops, batch 4, maxdisp 192; 4 train frames make one step an epoch.
TRAIN_H, TRAIN_W, TRAIN_B, TRAIN_EPOCHS = 288, 576, 4, 31
# The band kernel's gradient (its plain fp32 backward) against float64, rel L2.
TOL_BAND_GRAD = 1e-4
# One train step, kernel path against plain path (fp32, TF32 off): the loss
# (relative) and the per-tensor relative L2 of the gradients, 10x what the
# first H100 run measured (loss equal; gradients 1.13e-6 median, 1.03e-5
# worst: the paths share all but the head's forward).
TOL_STEP_LOSS = 1e-5
TOL_STEP_GRAD_MEDIAN, TOL_STEP_GRAD_WORST = 1e-5, 1e-4
# Phase 11, search. The reference search (scripts/search.sh): 192x384 crops,
# 10 epochs, arch steps from epoch 3, batch 2 (search.sh: 4; each bundled
# search list holds 2 frames and the loader drops the last partial batch):
# 10 weight steps, 7 arch steps and 10 val frames, one band launch each.
SEARCH_H, SEARCH_W, SEARCH_B, SEARCH_EPOCHS, SEARCH_ALPHA_EPOCH = 192, 384, 2, 10, 3
SEARCH_BAND_LAUNCHES = 27
# Remat on against off, one supernet step: the recomputed cells run the same
# kernels on the same inputs; gradients within 1e-4 relative (cuDNN's
# weight-gradient kernels may sum in another order), the running statistics
# equal to 1e-6.
TOL_REMAT_GRAD, TOL_REMAT_STATS = 1e-4, 1e-6

REPO = pathlib.Path(__file__).resolve().parent
KITTI_ROOT = str(REPO / "dataset" / "kitti15_part")  # 324x576 frames
CLI_H, CLI_W = 384, 1248
KITTI_ARGS = ["--dataset", "kitti15_part", "--data_root", KITTI_ROOT,
              "--listset", "kitti15_part", "--lists_dir", str(REPO / "dataloaders" / "lists"),
              "--crop_height", str(CLI_H), "--crop_width", str(CLI_W), "--maxdisp", "192", "--device", "cuda"]
# (run, driver, split, flags, the head each frame must launch)
CLI_RUNS = (
    ("evaluate", "evaluate", "train", [], "fused_head_sm90"),
    ("evaluate --confidence", "evaluate", "train", ["--confidence"], "band_soft_argmin"),
    ("evaluate --dtype float32", "evaluate", "train", ["--dtype", "float32"], "fused_head_sm90_f32"),
    ("predict", "predict", "test", [], "fused_head_sm90"),
    # The 324x576 frames under the fine-tune crop: padded whole to 336x576,
    # BEST_SCENEFLOW's multiple of 24 (the JAX drivers' 12 would give 324).
    ("evaluate --full_frame", "evaluate", "train", ["--full_frame", "--crop_height", "288", "--crop_width", "576"],
     "fused_head_sm90"),
)
# The input each run hands the model, for the runs whose frame 0 is held
# against the model called directly on it.
CLI_PADDED = {"evaluate": (CLI_H, CLI_W), "evaluate --full_frame": (336, 576)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emit_check(check: dict) -> None:
    """A ``kernel_parity`` check as a ``kernel_check`` line (its error and
    tolerance as ``max_abs_err_px`` and ``tol_px``); raises if it failed."""
    rest = {k: v for k, v in check.items() if k not in ("check", "max_abs_err", "atol", "ok")}
    emit({"phase": "kernel_check", **rest, "max_abs_err_px": check["max_abs_err"], "tol_px": check["atol"]})
    if not check["ok"]:
        raise AssertionError(f"{check['check']}: {check['max_abs_err']} px")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def by_kind(events, frames: int = 1) -> dict:
    """Device ms of profiler ``events`` a frame by ``KERNEL_GROUPS`` kind, largest first."""
    groups = {}
    for e in events:
        kind = next((k for k, pats in KERNEL_GROUPS if any(p in e.key for p in pats)), "other")
        groups[kind] = groups.get(kind, 0.0) + e.self_device_time_total / 1e3 / frames
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def bound(bytes_moved: int, flops: int, flop_dtype, exps: int) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over memory rate against operations
    (conv FLOPs at the peak of their input type, exponentials at the SFU rate)."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = max(flops / PEAK_FLOPS[flop_dtype], exps / PEAK_SFU_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


SPAN_300 = 300.0  # scale of the cost in phase wide_span_300x
# The route each shape of utils/kernel_parity.ROUTE_SHAPES takes.
SHAPE_ROUTES = {"c24": "sm90", "c12_search_widths": "sm90", "c80_groups": "sm90", "w412": "sm90_repitch",
                "w414_f32": "sm90_f32_repitch", "unaligned": "sm90_repitch"}


def route_shapes_phase(gen, maxdisp: int, dev, card: str) -> dict:
    """Phase 3, the route shapes (``utils/kernel_parity.ROUTE_SHAPES``): each
    volume, through ``conv_soft_argmin_cuda``, launches its route of
    ``SHAPE_ROUTES`` once and lands within TOL_KERNEL_PX of float64 on
    peaky, wide and diffuse inputs; then, on the diffuse one, the route and
    its two-call yardstick (cuDNN ``last_3`` in the volume's type, TF32 off,
    then the band kernel) in turns (route, yardstick, yardstick, route; best
    of two), the plain version once, and the bound. One line a shape; raises
    on a wrong route or error."""
    from leastereo_tpu_torch.ops.fused_head import (
        ROUTE_WRAPPERS,
        conv_soft_argmin_cuda,
        conv_soft_argmin_reference,
        fused_head_route,
    )
    from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda
    res = {}
    for name, (shape, dtype_name, offset) in kernel_parity.ROUTE_SHAPES.items():
        dtype = getattr(torch, dtype_name)
        b, c, d, h, w = shape
        route = SHAPE_ROUTES[name]
        line = {"phase": "route_shape", "card": card, "name": name, "shape": list(shape), "dtype": dtype_name,
                "offset_bytes": offset, "route": route, "tol_px": TOL_KERNEL_PX}
        for kind in kernel_parity.KINDS:
            vol32, kern = head_inputs(gen, kind, b, c, d, h, w, dev)
            vol = kernel_parity.offset_copy(vol32.to(dtype), offset)
            del vol32
            if fused_head_route(c, d, w, maxdisp, dtype, aligned=vol.data_ptr() % 16 == 0) != route:
                raise AssertionError(f"{name}: route is not {route}")
            n = {r: fn.launches for r, fn in ROUTE_WRAPPERS.items()}
            got = conv_soft_argmin_cuda(vol, kern, maxdisp)
            torch.cuda.synchronize()
            if {r: fn.launches - n[r] for r, fn in ROUTE_WRAPPERS.items()} != {r: int(r == route) for r in n}:
                raise AssertionError(f"{name}: not one launch of {route}")
            ref = conv_soft_argmin_reference(vol.double(), kern.double(), maxdisp)
            line[f"{kind}_max_abs_err_px"] = (got.double() - ref).abs().max().item()
            del got, ref
        kern_t = kern.to(dtype)
        fns = {"route": lambda: conv_soft_argmin_cuda(vol, kern, maxdisp),
               "yardstick": lambda: soft_argmin_cuda(F.conv3d(vol, kern_t, padding=1)[:, 0].float(), maxdisp)}
        turns = {key: [] for key in fns}
        for key in ("route", "yardstick", "yardstick", "route"):
            turns[key].append(cuda_ms(fns[key]))
        out_bytes = b * 9 * h * w * 4
        head_bound = bound(vol.numel() * vol.element_size() + kern.numel() * 4 + out_bytes,
                           2 * 27 * c * b * d * h * w, dtype, b * 9 * h * w * d)
        line.update({"ms": min(turns["route"]), "yardstick_ms": min(turns["yardstick"]), "turns_ms": turns,
                     "plain_ms": cuda_ms(lambda: conv_soft_argmin_reference(vol, kern, maxdisp), iters=3),
                     "bound_ms": head_bound[0], "bound_by": head_bound[1]})
        line["max_abs_err"] = max(line[f"{k}_max_abs_err_px"] for k in kernel_parity.KINDS)
        emit(line)
        if not line["max_abs_err"] < TOL_KERNEL_PX:
            raise AssertionError(f"{name}: {line['max_abs_err']} px from float64")
        res[name] = line
        del vol, kern, kern_t
        torch.cuda.empty_cache()
    return res


def _timed(fn, ms: list):
    """``fn``, appending the wall ms of each call to ``ms``."""

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        ms.append(1e3 * (time.perf_counter() - t0))
        return out

    return timed


@contextlib.contextmanager
def stage_times(calls: dict):
    """While the block runs, time every call of each function
    ``calls[label] = (owner, name)`` (wall ms, a list per label)."""
    times = {label: [] for label in calls}
    saved = []
    for label, (owner, name) in calls.items():
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, _timed(saved[-1][2], times[label]))
    try:
        yield times
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def sm90_head_check(gen, shape: tuple[int, ...], maxdisp: int) -> dict:
    """The sm90 head on seeded bf16 volumes of ``shape`` (peaky, wide,
    diffuse) against its plain version in float64 within TOL_KERNEL_PX, then
    its time, the plain version's and the bound on the diffuse one. Raises
    if a kind disagrees."""
    from leastereo_tpu_torch.ops.fused_head import conv_soft_argmin_reference, conv_soft_argmin_sm90

    b, c, d, h, w = shape
    head = {"shape": list(shape), "dtype": "torch.bfloat16", "tol_px": TOL_KERNEL_PX}
    for kind in ("peaky", "wide", "diffuse"):
        vol, kern = head_inputs(gen, kind, b, c, d, h, w, gen.device)
        vol = vol.to(torch.bfloat16)
        ref = conv_soft_argmin_reference(vol.double(), kern.double(), maxdisp)
        head[f"{kind}_max_abs_err_px"] = (conv_soft_argmin_sm90(vol, kern, maxdisp).double() - ref).abs().max().item()
        del ref
        if not head[f"{kind}_max_abs_err_px"] < TOL_KERNEL_PX:
            raise AssertionError(f"sm90 head at {list(shape)}, {kind}: {head}")
    head["ms"] = cuda_ms(lambda: conv_soft_argmin_sm90(vol, kern, maxdisp))
    head["plain_ms"] = cuda_ms(lambda: conv_soft_argmin_reference(vol, kern, maxdisp), iters=5)
    head["bound_ms"], head["bound_by"] = bound(vol.numel() * 2 + kern.numel() * 4 + b * 9 * h * w * 4,
                                               2 * 27 * b * c * d * h * w, torch.bfloat16, b * 9 * h * w * d)
    del vol, kern
    torch.cuda.empty_cache()
    return head


def cli_phase(model, counters: dict, card: str) -> dict:
    """Phase 8: the drivers' ``main(argv)`` on the bundled KITTI frames with
    ``model``'s weights as ``--checkpoint``. Returns each run's launches."""
    from leastereo_tpu_torch.cli import evaluate, predict
    from leastereo_tpu_torch.data import ListSet, StereoListDataset

    dev = next(model.parameters()).device
    lists = ListSet.resolve("kitti15_part", str(REPO / "dataloaders" / "lists"))
    # PyTorch's default, which a user's process has (phase 1 turned it off).
    torch.backends.cudnn.allow_tf32 = True
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "kitti_bf16.pth")
        torch.save(model.state_dict(), ckpt)
        for run, driver, split, flags, head in CLI_RUNS:
            mod = predict if driver == "predict" else evaluate
            out = os.path.join(tmp, run.replace(" ", "_").replace("-", ""))
            argv = KITTI_ARGS + ["--split", split, "--checkpoint", ckpt, "--output_dir", out] + flags
            with open(getattr(lists, split)) as f:
                names = [ln.strip().replace("/", "_") for ln in f if ln.strip()]
            for fn in counters.values():
                fn.launches = 0
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = mod.main(argv)
            launches = {k: fn.launches for k, fn in counters.items()}
            frames = len(names)
            if rc != 0:
                raise AssertionError(f"cli {run}: rc {rc}")
            if launches != {k: (frames if k == head else 0) for k in counters}:
                raise AssertionError(f"cli {run}: launches {launches}, expected {frames} of {head} only")
            suffixes = ([".png", ".npy"] if driver == "predict" else
                        ["_pred.png", "_gt.png", "_err.png", "_pred.npy", "_metrics.txt"])
            suffixes += ["_conf.png", "_conf.npy"] if "--confidence" in flags else []
            missing = [n + s for n in names for s in suffixes if not os.path.isfile(os.path.join(out, n + s))]
            if missing:
                raise AssertionError(f"cli {run}: missing outputs {missing}")
            metrics = []
            for n in names:
                disp = np.load(os.path.join(out, n + (".npy" if driver == "predict" else "_pred.npy")))
                if disp.shape != (324, 576) or not np.isfinite(disp).all():
                    raise AssertionError(f"cli {run} {n}: prediction {disp.shape}, finite {np.isfinite(disp).all()}")
                if driver == "evaluate":
                    with open(os.path.join(out, n + "_metrics.txt")) as f:
                        metrics.append({k: float(v) for k, v in (ln.split(": ") for ln in f.read().splitlines())})
            means = {k: float(np.mean([m[k] for m in metrics])) for k in (metrics[0] if metrics else {})}
            if not all(math.isfinite(v) for v in means.values()):
                raise AssertionError(f"cli {run}: metrics {means}")
            line = {"phase": "cli", "run": run, "card": card, "argv": ["--split", split] + flags, "frames": frames,
                    "launches": launches, "metrics_mean": means, "cudnn_tf32": True,
                    "note": "random seeded weights (phase 4's): the metrics show only that the pipeline runs"}
            if run in CLI_PADDED:
                # Frame 0 against phase 4's model on the same padded input,
                # un-padded the same way (after the counts were read).
                H, W = line["padded_to"] = CLI_PADDED[run]
                ds = StereoListDataset("kitti15_part", lists.train, root=KITTI_ROOT, crop_size=(H, W), training=False)
                s0 = ds[0]
                with torch.inference_mode():
                    direct = model(torch.from_numpy(s0.left[None]).to(dev), torch.from_numpy(s0.right[None]).to(dev))
                direct = direct[0].float().cpu().numpy()[H - 324 :, W - 576 :]
                got = np.load(os.path.join(out, names[0] + "_pred.npy"))
                line["frame0_vs_model_max_abs_px"] = float(np.abs(got - direct).max())
                line["frame0_tol_px"] = TOL_CLI_PX
                if not line["frame0_vs_model_max_abs_px"] < TOL_CLI_PX:
                    raise AssertionError(f"cli frame 0 differs from the model by {line['frame0_vs_model_max_abs_px']} px")
                if (H, W) != (CLI_H, CLI_W):
                    # The head at the volume this padded size gives it, held
                    # against float64 (the frame-0 check runs the same kernel
                    # on both sides, so it cannot see a wrong one).
                    shape = (1, 32, 64, H // 3, W // 3)
                    check = sm90_head_check(torch.Generator(device=dev).manual_seed(8), shape, 192)
                    line.update({f"head_{k}": v for k, v in check.items()})
            emit(line)
            result[run] = {"head": head, "launches": launches[head], "frames": frames}
    return result


def train_phase(counters: dict, card: str) -> dict:
    """Phase 10: training. The band kernel at the train forward's cost shape
    (forward and gradient), the sm90 head at the val frame's volume, one
    train step of the kernel path against the plain path, then
    ``cli.train.main`` on the KITTI fine-tune recipe. Returns the
    fine-tune's launches of each head and both heads' checks and times at
    the fine-tune's shapes."""
    import leastereo_tpu_torch.models.leastereo as lst
    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
    from leastereo_tpu_torch.cli import evaluate
    from leastereo_tpu_torch.cli import train as train_cli
    from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda, soft_argmin_fused
    from leastereo_tpu_torch.ops.softargmin import soft_argmin
    from leastereo_tpu_torch.train import masked_smooth_l1

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(6)
    b, d, h, w, maxdisp = TRAIN_B, 64, TRAIN_H // 3, TRAIN_W // 3, 192

    # 10a. The band kernel at the train forward's cost, forward against the
    # plain version in float64 and its gradient (the plain fp32 backward of
    # the autograd wrapper) against the float64 gradient.
    band = {"card": card, "shape": [b, d, h, w], "tol_px": TOL_KERNEL_PX, "tol_grad_rel_l2": TOL_BAND_GRAD}
    for kind in ("peaky", "diffuse"):
        cost = peaky_cost(gen, b, d, h, w, dev) if kind == "peaky" else torch.randn(b, d, h, w, generator=gen, device=dev)
        cost.requires_grad_(True)
        g_up = torch.randn(b, 3 * h, 3 * w, generator=gen, device=dev)
        out = soft_argmin_fused(cost, maxdisp)
        (g_k,) = torch.autograd.grad(out, cost, g_up)
        c64 = cost.detach().double().requires_grad_(True)
        ref = soft_argmin(c64, maxdisp)
        (g_r,) = torch.autograd.grad(ref, c64, g_up.double())
        band[f"{kind}_max_abs_err_px"] = (out.detach().double() - ref.detach()).abs().max().item()
        band[f"{kind}_grad_rel_l2"] = ((g_k.double() - g_r).norm() / g_r.norm()).item()
        if not (band[f"{kind}_max_abs_err_px"] < TOL_KERNEL_PX and band[f"{kind}_grad_rel_l2"] < TOL_BAND_GRAD):
            emit({"phase": "train_band_kernel", **band})
            raise AssertionError(f"band kernel at the train shape, {kind}: {band}")
        del c64, ref, g_r
    cost = cost.detach()
    cost16 = cost.to(torch.bfloat16).requires_grad_(True)
    band["ms"] = cuda_ms(lambda: soft_argmin_cuda(cost, maxdisp))
    band["plain_ms"] = cuda_ms(lambda: soft_argmin(cost, maxdisp), iters=5)
    band["fwd_bwd_ms"] = cuda_ms(lambda: soft_argmin_fused(cost16, maxdisp).backward(g_up), iters=5)
    band["plain_fwd_bwd_ms"] = cuda_ms(lambda: soft_argmin(cost16, maxdisp).backward(g_up), iters=5)
    exps = b * 9 * h * w * d
    band["bound_ms"], band["bound_by"] = bound(cost.numel() * 4 + b * 9 * h * w * 4, 0, torch.float32, exps)
    band["note"] = "fwd_bwd: bf16 cost as the model gives it, the kernel's forward and the plain backward"
    emit({"phase": "train_band_kernel", **band})
    del cost, cost16, g_up, out, g_k
    torch.cuda.empty_cache()

    # 10a'. The sm90 head at every val frame's pre-head volume (eval at
    # 288x576: (1, 32, 64, 96, 192) bf16) against its plain version in float64.
    head = sm90_head_check(gen, (1, 32, d, h, w), maxdisp)
    emit({"phase": "train_val_head", "card": card, **head})

    # 10b. One train step (forward, masked loss, backward), kernel path against
    # plain path, fp32 with TF32 off, same weights and batch. Both share the
    # backward but for the head's forward.
    hs, ws, md, bs = 96, 192, 48, 2
    rng = np.random.RandomState(6)
    left = torch.from_numpy(rng.randn(bs, hs, ws, 3).astype(np.float32)).to(dev)
    right = torch.from_numpy((2.0 * rng.randn(bs, hs, ws, 3)).astype(np.float32)).to(dev)
    target = rng.uniform(0.5, md - 1, (bs, hs, ws)).astype(np.float32)
    target[:, ::7, ::5] = 0.0
    target = torch.from_numpy(target).to(dev)
    base = best_sceneflow_model(LEAStereoConfig(maxdisp=md, compute_dtype="float32"), seed=2)
    state = {k: v.clone() for k, v in base.state_dict().items()}
    base.train()  # scale last_3 on the train-mode cost (this moves base's BN stats, not state's)
    with torch.no_grad():
        vol = base.matching(base.feature(left.permute(0, 3, 1, 2)), base.feature(right.permute(0, 3, 1, 2)), md // 3)
        state["matching.last_3.conv.weight"].mul_(3.0 / base.matching.last_3(vol).std())
    del base, vol
    steps = {}
    for pallas in (True, False):
        m = best_sceneflow_model(LEAStereoConfig(maxdisp=md, compute_dtype="float32", pallas_head=pallas))
        m.load_state_dict(state)
        m.train()
        n0 = soft_argmin_cuda.launches
        loss = masked_smooth_l1(m(left, right).float(), target, md)
        loss.backward()
        steps[pallas] = (loss.item(), {k: p.grad.double() for k, p in m.named_parameters()},
                         soft_argmin_cuda.launches - n0)
    (loss_k, grads_k, n_k), (loss_p, grads_p, n_p) = steps[True], steps[False]
    rels = {k: ((grads_k[k] - g).norm() / (g.norm() + 1e-30)).item() for k, g in grads_p.items()}
    worst = max(rels, key=rels.get)
    line = {"phase": "train_step_kernel_vs_plain", "card": card, "shape": [bs, hs, ws], "maxdisp": md,
            "dtype": "float32", "tf32": False, "loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p), "tol_loss_rel": TOL_STEP_LOSS,
            "grad_rel_l2_median": float(np.median(list(rels.values()))), "grad_rel_l2_worst": rels[worst],
            "grad_worst_tensor": worst, "tol_grad_median": TOL_STEP_GRAD_MEDIAN, "tol_grad_worst": TOL_STEP_GRAD_WORST,
            "band_launches": {"kernel_path": n_k, "plain_path": n_p}}
    emit(line)
    if (n_k, n_p) != (1, 0) or not line["loss_rel_diff"] < TOL_STEP_LOSS:
        raise AssertionError(f"train step, kernel against plain path: {line}")
    if not (line["grad_rel_l2_median"] < TOL_STEP_GRAD_MEDIAN and rels[worst] < TOL_STEP_GRAD_WORST):
        raise AssertionError(f"train step gradients, kernel against plain path: {line}")
    del steps, grads_k, grads_p, m, left, right, target
    torch.cuda.empty_cache()

    # 10c. The fine-tune through the driver, with the plain head barred from
    # the model (a cost the band kernel refused would raise in its wrapper).
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, a user's setting
    lists_dir = str(REPO / "dataloaders" / "lists")
    recipe = ["--dataset", "kitti15_part", "--data_root", KITTI_ROOT, "--listset", "kitti15_part",
              "--lists_dir", lists_dir, "--crop_height", str(TRAIN_H), "--crop_width", str(TRAIN_W),
              "--batch_size", str(TRAIN_B), "--maxdisp", str(maxdisp), "--lr", "1e-3", "--solver", "adam",
              "--loop_mode", "n_epochs", "--ckpt_period", "10", "--workers", "2", "--seed", "2019",
              "--device", "cuda"]

    def no_plain_head(*args, **kwargs):
        raise AssertionError("the model ran the plain soft_argmin head on the card")

    def read_log(run_dir):
        with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
            return [json.loads(ln) for ln in f]

    with tempfile.TemporaryDirectory() as tmp:
        for fn in counters.values():
            fn.launches = 0
        printed = io.StringIO()
        saved_plain, lst.soft_argmin = lst.soft_argmin, no_plain_head
        try:
            with contextlib.redirect_stdout(printed):
                rc = train_cli.main(recipe + ["--epochs", str(TRAIN_EPOCHS), "--run_root", tmp, "--experiment", "ft"])
        finally:
            lst.soft_argmin = saved_plain
        launches = {k: fn.launches for k, fn in counters.items()}
        exp = os.path.join(tmp, "kitti15_part-train", "ft")
        log = read_log(exp)
        train_log = [ln for ln in log if "loss" in ln]
        val_log = [ln for ln in log if "val_err3" in ln]
        ckpts = {kind: sorted(os.listdir(os.path.join(exp, "checkpoints", kind)))
                 for kind in os.listdir(os.path.join(exp, "checkpoints"))}
        line = {"phase": "train", "card": card, "recipe": recipe + ["--epochs", str(TRAIN_EPOCHS)], "rc": rc,
                "launches": launches, "logged": [{k: ln[k] for k in ("step", "loss", "epe", "err3")} for ln in train_log],
                "val_err3": [ln["val_err3"] for ln in val_log], "checkpoints": ckpts}
        losses = [ln["loss"] for ln in train_log]
        # One step and one val frame an epoch: the band kernel once a step,
        # the sm90 head once a val frame.
        ok = (rc == 0 and len(val_log) == TRAIN_EPOCHS
              and all(math.isfinite(x) for x in losses) and train_log[-1]["step"] == TRAIN_EPOCHS
              and losses[-1] < 0.5 * losses[0]
              and launches == {k: TRAIN_EPOCHS if k in ("band_soft_argmin", "fused_head_sm90") else 0 for k in counters}
              and ckpts.get("best") and ckpts.get("final") == [f"{TRAIN_EPOCHS}.pth"])
        if not ok:
            emit(line)
            raise AssertionError(f"fine-tune: {line}")

        # The final checkpoint loads into evaluate; a resumed run from best
        # starts below the cold run's first loss.
        final = os.path.join(exp, "checkpoints", "final", f"{TRAIN_EPOCHS}.pth")
        with contextlib.redirect_stdout(printed):
            rc_eval = evaluate.main(KITTI_ARGS + ["--split", "val", "--checkpoint", final, "--crop_height", str(TRAIN_H),
                                                  "--crop_width", str(TRAIN_W), "--output_dir", os.path.join(tmp, "eval")])
            rc_resume = train_cli.main(recipe + ["--epochs", "1", "--run_root", tmp, "--experiment", "resume",
                                                 "--resume", os.path.join(exp, "checkpoints", "best")])
        resumed = read_log(os.path.join(tmp, "kitti15_part-train", "resume"))[0]
        line.update({"evaluate_final_rc": rc_eval, "resume_from_best_step1_loss": resumed["loss"],
                     "cold_step1_loss": losses[0]})
        if rc_eval != 0 or rc_resume != 0 or not resumed["loss"] < losses[0]:
            emit(line)
            raise AssertionError(f"fine-tune checkpoints: {line}")
    emit(line)
    torch.cuda.empty_cache()
    return {"train_steps": TRAIN_EPOCHS, "val_frames": TRAIN_EPOCHS, "launches": launches,
            "band_ms": band["ms"], "band_plain_ms": band["plain_ms"], "band_bound_ms": band["bound_ms"],
            "band_bound_by": band["bound_by"], "band_err": max(band["peaky_max_abs_err_px"], band["diffuse_max_abs_err_px"]),
            "head_ms": head["ms"], "head_plain_ms": head["plain_ms"], "head_bound_ms": head["bound_ms"],
            "head_err": max(head[f"{kind}_max_abs_err_px"] for kind in ("peaky", "wide", "diffuse"))}


def search_phase(counters: dict, card: str) -> dict:
    """Phase 11: NAS search. The band kernel at the search cost against
    float64; one supernet weight step, kernel path against plain path and
    remat on against off; ``cli.search.main`` on the reference search
    configuration (scripts/search.sh) over the bundled ``sceneflow_part``
    lists, then ``cli.decode.main`` on its ``best`` checkpoint and the
    decoded network serving one KITTI frame. Returns the band kernel's
    launches, check and times at the search cost, and the decoded frame's
    sm90 launches."""
    import argparse

    import leastereo_tpu_torch.search.supernet as supernet_mod
    from leastereo_tpu_torch.cli import decode as decode_cli
    from leastereo_tpu_torch.cli import search as search_cli
    from leastereo_tpu_torch.cli.common import build_model
    from leastereo_tpu_torch.cli.config import add_model_args, search_parser
    from leastereo_tpu_torch.models.genotypes import load_architecture
    from leastereo_tpu_torch.models.matching_net import DEFAULT_SKIPS, MatchingNet
    from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda
    from leastereo_tpu_torch.ops.softargmin import soft_argmin
    from leastereo_tpu_torch.search import AutoStereoSupernet, SupernetConfig, search_loss

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(11)

    # 11a. The band kernel at the search cost: (2, 64, 64, 128) at 192x384,
    # maxdisp 192, against the plain version in float64.
    b, d, h, w, maxdisp = SEARCH_B, 64, SEARCH_H // 3, SEARCH_W // 3, 192
    band = {"card": card, "shape": [b, d, h, w], "tol_px": TOL_KERNEL_PX}
    for kind in ("peaky", "wide", "diffuse"):
        if kind == "diffuse":
            cost = torch.randn(b, d, h, w, generator=gen, device=dev)
        else:
            cost = peaky_cost(gen, b, d, h, w, dev) * (WIDE if kind == "wide" else 1.0)
        band[f"{kind}_max_abs_err_px"] = (
            soft_argmin_cuda(cost, maxdisp).double() - soft_argmin(cost.double(), maxdisp)).abs().max().item()
        if not band[f"{kind}_max_abs_err_px"] < TOL_KERNEL_PX:
            emit({"phase": "search_band_kernel", **band})
            raise AssertionError(f"band kernel at the search cost, {kind}: {band}")
    band["ms"] = cuda_ms(lambda: soft_argmin_cuda(cost, maxdisp))
    band["plain_ms"] = cuda_ms(lambda: soft_argmin(cost, maxdisp), iters=5)
    band["bound_ms"], band["bound_by"] = bound(cost.numel() * 4 + b * 9 * h * w * 4, 0, torch.float32, b * 9 * h * w * d)
    emit({"phase": "search_band_kernel", **band})
    del cost

    # 11b. One supernet weight step's gradients (forward, search loss,
    # backward), kernel path against plain path and remat on against off,
    # fp32 with TF32 off, 96x192, maxdisp 48, the reference's 6/12-layer
    # filter-4 block-3 step-3 nets.
    hs, ws, md, bs = 96, 192, 48, 2
    rng = np.random.RandomState(11)
    left = torch.from_numpy(rng.randn(bs, hs, ws, 3).astype(np.float32)).to(dev)
    right = torch.from_numpy((2.0 * rng.randn(bs, hs, ws, 3)).astype(np.float32)).to(dev)
    target = torch.from_numpy(rng.uniform(0.0, md - 1, (bs, hs, ws)).astype(np.float32)).to(dev)

    def supernet(remat: bool) -> AutoStereoSupernet:
        fea, mat = (SupernetConfig(n, 4, 3, 3, remat=remat) for n in (6, 12))
        return AutoStereoSupernet(md, fea, mat, dtype=torch.float32, generator=torch.Generator().manual_seed(11)).to(dev)

    base = supernet(True).train()  # scale last_3 on the train-mode cost (moves base's BN stats only)
    state = {k: v.clone() for k, v in base.state_dict().items()}
    with torch.no_grad():
        fl, fr = (base.feature(x.permute(0, 3, 1, 2)) for x in (left, right))
        state["matching.last_3.conv.weight"].mul_(3.0 / base.matching(supernet_mod.build_cost_volume(fl, fr, md // 3)).std())
    del base, fl, fr
    runs = {}
    for name, remat, head in (("kernel", True, None), ("plain", True, soft_argmin), ("kernel_no_remat", False, None)):
        m = supernet(remat)
        m.load_state_dict(state)
        m.train()
        n0 = soft_argmin_cuda.launches
        saved = supernet_mod.soft_argmin_fused
        if head is not None:
            supernet_mod.soft_argmin_fused = head
        try:
            loss = search_loss(m(left, right).float(), target, md)
            loss.backward()
        finally:
            supernet_mod.soft_argmin_fused = saved
        runs[name] = (loss.item(), {k: p.grad.double() for k, p in m.named_parameters()},
                      soft_argmin_cuda.launches - n0,
                      {k: v for k, v in m.state_dict().items() if "running" in k or "num_batches" in k})
        del m, loss

    def rel_l2(a: dict, b: dict) -> dict:
        return {k: ((a[k] - g).norm() / (g.norm() + 1e-30)).item() for k, g in b.items()}

    (loss_k, g_k, n_k, st_k), (loss_p, g_p, n_p, _), (loss_n, g_n, n_n, st_n) = (
        runs["kernel"], runs["plain"], runs["kernel_no_remat"])
    rels, rels_remat = rel_l2(g_k, g_p), rel_l2(g_k, g_n)
    worst, worst_remat = max(rels, key=rels.get), max(rels_remat, key=rels_remat.get)
    stats_diff = max(((st_k[k].double() - v.double()).abs().max().item() for k, v in st_n.items()), default=0.0)
    line = {"phase": "search_step_kernel_vs_plain", "card": card, "shape": [bs, hs, ws], "maxdisp": md,
            "nets": "6/12 layers, filter 4, block 3, steps 3", "dtype": "float32", "tf32": False,
            "loss_kernel": loss_k, "loss_plain": loss_p, "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
            "tol_loss_rel": TOL_STEP_LOSS, "grad_rel_l2_median": float(np.median(list(rels.values()))),
            "grad_rel_l2_worst": rels[worst], "grad_worst_tensor": worst, "tol_grad_median": TOL_STEP_GRAD_MEDIAN,
            "tol_grad_worst": TOL_STEP_GRAD_WORST, "band_launches": {"kernel_path": n_k, "plain_path": n_p},
            "remat_off_loss": loss_n, "remat_loss_rel_diff": abs(loss_k - loss_n) / abs(loss_n),
            "remat_grad_rel_l2_worst": rels_remat[worst_remat], "remat_grad_worst_tensor": worst_remat,
            "remat_running_stats_max_abs_diff": stats_diff, "tol_remat_grad": TOL_REMAT_GRAD,
            "tol_remat_stats": TOL_REMAT_STATS}
    emit(line)
    if (n_k, n_p, n_n) != (1, 0, 1) or not line["loss_rel_diff"] < TOL_STEP_LOSS:
        raise AssertionError(f"search step, kernel against plain path: {line}")
    if not (line["grad_rel_l2_median"] < TOL_STEP_GRAD_MEDIAN and rels[worst] < TOL_STEP_GRAD_WORST):
        raise AssertionError(f"search step gradients, kernel against plain path: {line}")
    if not (line["remat_loss_rel_diff"] < TOL_STEP_LOSS and rels_remat[worst_remat] < TOL_REMAT_GRAD
            and stats_diff <= TOL_REMAT_STATS and st_k.keys() == st_n.keys()):
        raise AssertionError(f"search step, remat on against off: {line}")
    del runs, g_k, g_p, g_n, left, right, target, state
    torch.cuda.empty_cache()

    # 11c. The reference search through cli.search (scripts/search.sh), batch 2.
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, a user's setting
    sf_root = str(REPO / "dataset" / "sceneflow_part")
    recipe = ["--dataset", "sceneflow_part", "--data_root", sf_root, "--listset", "sceneflow_part",
              "--lists_dir", str(REPO / "dataloaders" / "lists"), "--crop_height", str(SEARCH_H),
              "--crop_width", str(SEARCH_W), "--maxdisp", str(maxdisp),
              "--fea_filter_multiplier", "4", "--fea_block_multiplier", "3", "--fea_step", "3",
              "--mat_filter_multiplier", "4", "--mat_block_multiplier", "3", "--mat_step", "3",
              "--fea_num_layers", "6", "--mat_num_layers", "12", "--dtype", "bfloat16",
              "--batch_size", str(SEARCH_B), "--epochs", str(SEARCH_EPOCHS), "--alpha_epoch", str(SEARCH_ALPHA_EPOCH),
              "--lr", "0.025", "--min_lr", "0.001", "--arch_lr", "0.001", "--workers", "2", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        argv = recipe + ["--run_root", tmp, "--experiment", "search"]
        init = search_cli.build_supernet(search_parser().parse_args(argv)).state_dict()
        init_betas = {k: init[k].cpu() for k in ("feature.betas", "matching.betas")}
        del init
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        metrics = []

        def keep(fn):
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                metrics.append(out)
                return out
            return wrapped

        saved_ws = search_cli.weight_step
        search_cli.weight_step = keep(saved_ws)
        t0 = time.perf_counter()
        try:
            with stage_times({"weight_step": (search_cli, "weight_step"), "arch_step": (search_cli, "arch_step"),
                              "eval_step": (search_cli, "eval_step")}) as ms, contextlib.redirect_stdout(printed):
                rc = search_cli.main(argv)
        finally:
            search_cli.weight_step = saved_ws
        run_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        exp = os.path.join(tmp, "sceneflow_part-search", "search")
        ckpt = os.path.join(exp, "checkpoints")
        kinds = {kind: sorted(os.listdir(os.path.join(ckpt, kind))) for kind in os.listdir(ckpt)}
        betas = {}
        for e in range(SEARCH_EPOCHS):
            sd = torch.load(os.path.join(ckpt, "latest", f"{e}.pth"), map_location="cpu", weights_only=True)["state_dict"]
            betas[e] = {k: sd[k] for k in init_betas}
        n_w, n_a, n_v = len(ms["weight_step"]), len(ms["arch_step"]), len(ms["eval_step"])
        frozen = all(torch.equal(betas[e][k], init_betas[k]) for e in range(SEARCH_ALPHA_EPOCH) for k in init_betas)
        moved = all(not torch.equal(betas[e][k], betas[e - 1][k])
                    for e in range(SEARCH_ALPHA_EPOCH, SEARCH_EPOCHS) for k in init_betas)
        expect = {"band_soft_argmin": n_w + n_a + n_v}
        line = {"phase": "search", "card": card, "recipe": recipe, "rc": rc, "seconds": run_s,
                "weight_steps": n_w, "arch_steps": n_a, "val_frames": n_v, "launches": launches,
                "weight_step_ms_median_3_on": float(np.median(ms["weight_step"][2:])),
                "arch_step_ms_median_3_on": float(np.median(ms["arch_step"][2:])),
                "val_frame_ms_median": float(np.median(ms["eval_step"])),
                "weight_step_ms": ms["weight_step"], "arch_step_ms": ms["arch_step"], "val_frame_ms": ms["eval_step"],
                "peak_mem_gb": peak_gb, "losses": [m["loss"] for m in metrics], "checkpoints": kinds,
                "betas_frozen_before_alpha_epoch": frozen, "betas_move_from_alpha_epoch": moved,
                "note": "step ms: host wall time of weight_step / arch_step, each ending in a host read of the loss"}
        emit(line)
        expected_steps = (SEARCH_EPOCHS, SEARCH_EPOCHS - SEARCH_ALPHA_EPOCH, SEARCH_EPOCHS)
        if not (rc == 0 and (n_w, n_a, n_v) == expected_steps and sum(expected_steps) == SEARCH_BAND_LAUNCHES
                and launches == {k: expect.get(k, 0) for k in counters}
                and all(math.isfinite(m["loss"]) for m in metrics) and frozen and moved and kinds.get("best")):
            raise AssertionError(f"search: {line}")

        # One more weight step of the recipe's shapes under the profiler: the
        # device time by kernel kind, the kernels launched, and the device's
        # idle share against cli.search's untraced median step.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from leastereo_tpu_torch.data import ListSet, StereoListDataset, make_loader
        from leastereo_tpu_torch.search import make_weight_optimizer, weight_step

        args = search_parser().parse_args(argv)
        ds = StereoListDataset("sceneflow_part", ListSet.resolve("sceneflow_part", args.lists_dir).search_weights,
                               root=sf_root, crop_size=(SEARCH_H, SEARCH_W), training=True, seed=args.seed)
        batch = next(iter(make_loader(ds, SEARCH_B, device=dev, seed=args.seed, num_workers=2)(0)))
        model = search_cli.build_supernet(args)
        opt = make_weight_optimizer(model.weight_parameters(), args.lr)
        weight_step(model, opt, batch, maxdisp, args.lr)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            weight_step(model, opt, batch, maxdisp, args.lr)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        prof_line = {"phase": "search_step_profile", "card": card, "profiled_step_device_ms": busy_ms,
                     "device_idle_share": 1 - busy_ms / line["weight_step_ms_median_3_on"],
                     "device_ops": sum(e.count for e in events),
                     "band_kernel_device_ms": sum(e.self_device_time_total for e in events if "band_kernel" in e.key) / 1e3,
                     "device_ms_by_kind": by_kind(events),
                     "top_kernels_ms": [[e.key[:100], e.self_device_time_total / 1e3, e.count]
                                        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]],
                     "note": "idle share: against cli.search's untraced median weight step (steps 3 on)"}
        emit(prof_line)
        if not prof_line["band_kernel_device_ms"] > 0:
            raise AssertionError("the profiled search step shows no band kernel time")
        del model, opt, batch, prof, events

        # 11d. Decode best, then the decoded network at the serving width
        # (filter 8, block 4) on one KITTI frame, bf16, eval.
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc_dec = decode_cli.main(["--checkpoint", os.path.join(ckpt, "best"), "--out_dir", os.path.join(tmp, "arch")])
        files = {k: os.path.join(tmp, "arch", f) for k, f in (
            ("net_arch_fea", "feature_network_path.npy"), ("cell_arch_fea", "feature_genotype.npy"),
            ("net_arch_mat", "matching_network_path.npy"), ("cell_arch_mat", "matching_genotype.npy"))}
        paths = {k: np.load(files[k]).tolist() for k in ("net_arch_fea", "net_arch_mat")}
        legal = all(p[0] in (0, 1) and all(abs(a - c) <= 1 for a, c in zip(p, p[1:])) for p in paths.values())
        parser = argparse.ArgumentParser()
        add_model_args(parser)
        args = parser.parse_args(["--maxdisp", "192", "--dtype", "bfloat16", "--device", "cuda",
                                  *[x for k, f in files.items() for x in (f"--{k}", f)]])
        model = build_model(args, seed=0)
        # The skip model joins cells 1 and 4, and 4 and 8, by a channel concat
        # (reference skip_model_3d.py:150-156; the JAX MatchingNet alike), so
        # it takes only a matching path with each pair at one level. A searched
        # path without that is served through the reference's non-skip
        # matching net (MatchingNet(skips=()), retrain/new_model_3d.py).
        mat_path = paths["net_arch_mat"]
        skip_levels = [(mat_path[a], mat_path[t]) for a, t in DEFAULT_SKIPS]
        skip_model = all(a == t for a, t in skip_levels)
        if not skip_model:
            cfg = model.config
            model.matching = MatchingNet(
                load_architecture(files["net_arch_mat"], files["cell_arch_mat"]),
                cfg.fea_filter_multiplier * cfg.fea_block_multiplier, cfg.mat_filter_multiplier,
                cfg.mat_block_multiplier, cfg.mat_steps, skips=(), generator=torch.Generator().manual_seed(0),
            ).to(dev).eval()
        rng = np.random.RandomState(12)
        l, r = (torch.from_numpy(rng.randn(1, CLI_H, CLI_W, 3).astype(np.float32)).to(dev) for _ in range(2))
        for fn in counters.values():
            fn.launches = 0
        with torch.inference_mode():
            disp = model(l, r)
            torch.cuda.synchronize()
        decode_launches = {k: fn.launches for k, fn in counters.items()}
        d_np = disp.float().cpu().numpy()
        dline = {"phase": "search_decode", "card": card, "rc": rc_dec, "paths": paths, "legal_paths": legal,
                 "matching_skip_levels": skip_levels, "matching_net": "skip" if skip_model else "non-skip",
                 "genotypes": {k: np.load(files[k]).tolist() for k in ("cell_arch_fea", "cell_arch_mat")},
                 "shape": list(d_np.shape), "finite": bool(np.isfinite(d_np).all()), "launches": decode_launches}
        emit(dline)
        if not (rc_dec == 0 and legal and d_np.shape == (1, CLI_H, CLI_W) and dline["finite"]
                and decode_launches == {k: (1 if k == "fused_head_sm90" else 0) for k in counters}):
            raise AssertionError(f"decode and serve: {dline}")
        del model, disp
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    emit({"phase": "search_seconds", "seconds": time.perf_counter() - t_phase})
    return {"launches": launches["band_soft_argmin"], "ms": band["ms"], "plain_ms": band["plain_ms"],
            "bound_ms": band["bound_ms"], "err": max(band[f"{k}_max_abs_err_px"] for k in ("peaky", "wide", "diffuse")),
            "decode_launches": decode_launches["fused_head_sm90"], "weight_step_ms": line["weight_step_ms_median_3_on"],
            "arch_step_ms": line["arch_step_ms_median_3_on"], "peak_mem_gb": peak_gb,
            "step_device_ms": busy_ms, "step_idle_share": prof_line["device_idle_share"]}


# Phase 12, parallel runs. The card machine has one H100 and NCCL refuses two
# ranks on one device, so parity across ranks runs over gloo with CUDA tensors
# (two processes on the card) and NCCL at world size 1. (a) The disparity-
# sharded KITTI frame against the one-process frame with the plain head (the
# maths the sharded head shares), fp32, TF32 off; (b) three data-parallel
# steps at the fine-tune shapes and (d) three disparity-sharded steps at the
# Middlebury recipe's against one process on the same global batches.
PAR_RANKS = 2
PAR_MAXDISPS = (192, 408)
TOL_PAR_PX = 1e-3
PAR_STEPS = 3
# (b) SGD (momentum 0.9, lr 1e-3), whose update is linear in the gradient:
# Adam's first updates are near sign(g), and a gradient within rounding of 0
# flips sign between any two summation orders (a first call measured the
# one-process Adam run against itself with its rows reordered 2.2e-4 apart in
# step 3's loss). Bounds: step 1's loss within 1e-4 relative; the gradients of
# a train-mode BN net are chaotically conditioned in fp32 (see
# tests/test_torch_parallel.py), so step 1's gradient and every step's loss
# must stay within 2x of the deviation that the one-process run with the rows
# of each global batch reordered (equal in exact arithmetic) shows from the
# one-process run, plus 1e-6 on the gradient's relative L2 and 1e-5 relative
# on each loss.
TOL_PAR_LOSS = 1e-4
PAR_NOISE_FACTOR = 2.0
PAR_LR = 1e-3
# (d) The Middlebury fine-tune of scripts/train_md.sh (BASELINE.md:23):
# 384x576 crops, maxdisp 408 (D = 136 planes, 68 a rank), batch 2, Adam 1e-3,
# on seeded synthetic batches (the repo holds no Middlebury frames). Parity:
# MD_PARITY_STEPS fp32 SGD steps (TF32 off) with the bounds of (b); timing:
# MD_TIMED_STEPS bf16 Adam steps on the two ranks, the last with its
# collectives clocked, and MD_ONE_STEPS in one process beside them.
MD_H, MD_W, MD_MAXDISP, MD_B, MD_LR = 384, 576, 408, 2, 1e-3
MD_PARITY_STEPS, MD_TIMED_STEPS, MD_ONE_STEPS = 3, 8, 4
MD_SEED = 408


def _collective_kind() -> str:
    """The layer that called ``all_reduce``: the first frame, from the caller
    outwards, that names one."""
    f = sys._getframe(2)
    while f is not None:
        path, fn = f.f_code.co_filename, f.f_code.co_name
        if path.endswith("halo.py"):
            return "halo exchange and adjoint"
        if path.endswith("softargmin.py"):
            return "head"
        if path.endswith(os.path.join("distributed", "nn", "functional.py")):
            return "BN statistics"  # sync-BN's differentiable all_reduce, forward and backward
        if fn == "all_reduce_grads":
            return "gradient sum"
        if fn in ("global_count", "global_metrics"):
            return "count and metrics"
        f = f.f_back
    return "other"


def new_clock() -> dict:
    return {"ms": 0.0, "calls": 0, "kinds": {}}


@contextlib.contextmanager
def collective_clock(stats: dict):
    """While the block runs, time every ``torch.distributed.all_reduce`` (the
    exchange, sync-BN, gradients and metrics all call it) with the card
    synchronised on either side: ``stats["ms"]``, ``stats["calls"]``, and
    both by the layer that called it (``stats["kinds"]``)."""
    import torch.distributed as dist

    orig = dist.all_reduce

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        kind = stats["kinds"].setdefault(_collective_kind(), {"calls": 0, "ms": 0.0})
        for d in (stats, kind):
            d["ms"] += ms
            d["calls"] += 1
        return out

    dist.all_reduce = timed
    try:
        yield stats
    finally:
        dist.all_reduce = orig


def head_counters() -> dict:
    """The launch counters of the head kernels, by kernel: the fused head's
    four routes and the band kernel."""
    from leastereo_tpu_torch.ops.fused_head import ROUTE_WRAPPERS
    from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda

    return {**{f"fused_head_{route}": fn for route, fn in ROUTE_WRAPPERS.items()}, "band_soft_argmin": soft_argmin_cuda}


def _par_rows(batch: dict, rank: int, world: int, order=None) -> dict:
    """Rank ``rank``'s rows of a global batch (all rows with ``world`` 1), as
    float32 tensors on the card, in ``order`` when given."""
    n = batch["left"].shape[0] // world
    out = {}
    for k, v in batch.items():
        v = v if order is None else v[order]
        out[k] = torch.from_numpy(np.ascontiguousarray(v[rank * n : (rank + 1) * n])).cuda()
    return out


def train_run(sd: dict, batches: list, lr: float, *, maxdisp: int = 192, dtype: str = "float32",
              solver: str = "sgd", order=None, mesh=None, rank: int = 0, world: int = 1,
              sharded: bool = False, clock_last: bool = False) -> dict:
    """Train steps of ``BEST_SCENEFLOW`` at full width on this rank's rows
    of ``batches`` (rows ``rank`` of ``world``; all rows with ``world`` 1,
    as the disp ranks of a data row hold), over ``mesh`` when given and
    disparity-sharded with ``sharded``: the losses, step 1's flat gradient
    (fp32), each step's ms, the head kernels' launches (zeroed just before
    the steps, read just after), the last step's collectives with
    ``clock_last``, and the peak memory."""
    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
    from leastereo_tpu_torch.train import make_optimizer, train_step

    pspec = ("data", "disp") if sharded else None
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype=dtype, cost_volume_pspec=pspec))
    model.load_state_dict(sd)
    model.mesh = mesh
    opt = make_optimizer(model.parameters(), solver, lr, momentum=0.9)
    heads = head_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, grad1, clock = [], [], None, new_clock()
    for fn in heads.values():
        fn.launches = 0
    for i, batch in enumerate(batches):
        rows = _par_rows(batch, rank, world, order)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_clock(clock) if (clock_last and i == len(batches) - 1) else contextlib.nullcontext():
            losses.append(train_step(model, opt, rows, maxdisp, lr, mesh=mesh)["loss"])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0 and dtype == "float32":
            grad1 = torch.cat([p.grad.detach().double().flatten() for p in model.parameters()]).cpu()
    return {"losses": losses, "grad1": grad1, "step_ms": step_ms, "clock": clock,
            "launches": {k: fn.launches for k, fn in heads.items()}, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def md_batch(seed: int) -> dict:
    """A seeded global batch at the Middlebury recipe's shapes: targets up to
    maxdisp 408, one pixel in 15 invalid (0)."""
    rng = np.random.RandomState(seed)
    target = rng.uniform(0.5, MD_MAXDISP - 8.0, size=(MD_B, MD_H, MD_W)).astype(np.float32)
    target[:, ::5, ::3] = 0.0
    return {"left": rng.randn(MD_B, MD_H, MD_W, 3).astype(np.float32),
            "right": rng.randn(MD_B, MD_H, MD_W, 3).astype(np.float32), "disparity": target}


def rank_main(argv: list) -> int:
    """One rank of phase 12, run as ``chip_smoke.py --rank RANK WORLD PORT DIR``:
    the sharded frames of (a), the data-parallel steps of (b), then the
    disparity-sharded train steps of (d), on card 0 over gloo. Writes
    ``DIR/out{RANK}.pt``."""
    rank, world, port, work = int(argv[0]), int(argv[1]), argv[2], pathlib.Path(argv[3])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
    from leastereo_tpu_torch.parallel import initialize, make_mesh

    heads = head_counters()
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda")
    inp = torch.load(work / "in.pt", weights_only=False)
    left, right = (torch.from_numpy(inp[k]).cuda() for k in ("left", "right"))
    mesh = make_mesh(data=1, disp=world)
    out = {}
    # (a) fp32 sharded frames; then bf16: frame ms, one frame with the
    # collectives clocked, this rank's peak memory.
    for md in PAR_MAXDISPS:
        model = best_sceneflow_model(LEAStereoConfig(maxdisp=md, compute_dtype="float32",
                                                     cost_volume_pspec=("data", "disp")))
        model.load_state_dict(inp[f"sd{md}"])
        model.mesh = mesh
        torch.cuda.reset_peak_memory_stats()
        for fn in heads.values():
            fn.launches = 0
        with torch.inference_mode():
            disp = model(left, right)
            torch.cuda.synchronize()
        out[f"fp32_{md}"] = disp.cpu()
        out[f"fp32_{md}_launches"] = {k: fn.launches for k, fn in heads.items()}
        out[f"fp32_{md}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=192, compute_dtype="bfloat16",
                                                 cost_volume_pspec=("data", "disp")))
    model.load_state_dict(inp["sd192"])
    model.mesh = mesh
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in heads.values():
        fn.launches = 0
    with torch.inference_mode():
        for _ in range(2):
            disp = model(left, right)
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 5
        for _ in range(n):
            disp = model(left, right)
        torch.cuda.synchronize()
        out["bf16_ms_per_frame"] = 1e3 * (time.perf_counter() - t0) / n
        with collective_clock(new_clock()) as clock:
            disp = model(left, right)
    out["bf16_frames"] = 2 + n + 1
    out["bf16_launches"] = {k: fn.launches for k, fn in heads.items()}
    out["bf16_exchange_ms_per_frame"], out["bf16_exchange_calls_per_frame"] = clock["ms"], clock["calls"]
    out["bf16_finite"] = bool(torch.isfinite(disp).all())
    out["bf16_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # (b) the data-parallel steps over the data axis.
    out["train"] = train_run(inp["sd_train"], inp["batches"], inp["lr"], mesh=make_mesh(data=world, disp=1),
                             rank=rank, world=world, clock_last=True)
    # (d) the Middlebury fine-tune disparity-sharded over the two ranks: the
    # fp32 SGD parity steps, then the bf16 recipe timed.
    md = dict(maxdisp=MD_MAXDISP, mesh=mesh, sharded=True)
    out["md_parity"] = train_run(inp["sd_md"], inp["md_batches"], inp["lr"], **md)
    out["md_timed"] = train_run(inp["sd_md"], [md_batch(MD_SEED + i) for i in range(MD_TIMED_STEPS)], MD_LR,
                                dtype="bfloat16", solver="adam", clock_last=True, **md)
    torch.save(out, work / f"out{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def parallel_phase(counters: dict, card: str) -> dict:
    """Phase 12: (a) the disparity-sharded KITTI frame, (b) data-parallel
    steps and (d) disparity-sharded Middlebury train steps on two gloo ranks
    of the card, each held against one process; (c) ``cli.train
    --multihost`` at world size 1 over NCCL."""
    import socket

    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
    from leastereo_tpu_torch.cli import train as train_cli

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # phase 10 turned it on
    torch.backends.cuda.matmul.allow_tf32 = False
    H, W = 384, 1248
    rng = np.random.RandomState(12)
    left_np = rng.randn(1, H, W, 3).astype(np.float32)
    right_np = rng.randn(1, H, W, 3).astype(np.float32)
    left, right = torch.from_numpy(left_np).cuda(), torch.from_numpy(right_np).cuda()
    inp = {"left": left_np, "right": right_np, "lr": PAR_LR}
    # (a) references: the one-process fp32 frame with the plain head, and the
    # same model in float64 (how far fp32 rounding alone moves the frame);
    # beside them, not held, the fp32 frame with its volumes kept NCDHW, as
    # the sharded path keeps them (the eval frame's are NDHWC).
    from unittest import mock

    from leastereo_tpu_torch.models.matching_net import MatchingNet

    ref, ref64, ref_ncdhw = {}, {}, {}
    for md in PAR_MAXDISPS:
        model = best_sceneflow_model(LEAStereoConfig(maxdisp=md, compute_dtype="float32", pallas_head=False), seed=md)
        calibrate_head(model, left, right)
        model64 = best_sceneflow_model(LEAStereoConfig(maxdisp=md, compute_dtype="float64", pallas_head=False))
        model64.load_state_dict(model.state_dict())
        with torch.inference_mode():
            ref[md] = model(left, right).cpu()
            ref64[md] = model64(left.double(), right.double()).cpu()
            with mock.patch.object(MatchingNet, "layout", lambda self, part: torch.contiguous_format):
                ref_ncdhw[md] = model(left, right).cpu()
        inp[f"sd{md}"] = {k: v.cpu() for k, v in model.state_dict().items()}
        del model, model64
    torch.cuda.empty_cache()
    # (b) references: PAR_STEPS global batches of the fine-tune shapes; rank
    # 1's rows hold fewer valid pixels than rank 0's.
    batches = []
    for _ in range(PAR_STEPS):
        target = rng.uniform(0.5, 150.0, size=(TRAIN_B, TRAIN_H, TRAIN_W)).astype(np.float32)
        target[TRAIN_B // 2 :, : TRAIN_H // 2] = 0.0
        batches.append({"left": rng.randn(TRAIN_B, TRAIN_H, TRAIN_W, 3).astype(np.float32),
                        "right": rng.randn(TRAIN_B, TRAIN_H, TRAIN_W, 3).astype(np.float32), "disparity": target})
    inp["batches"] = batches
    train_model = best_sceneflow_model(LEAStereoConfig(maxdisp=192, compute_dtype="float32"), seed=12)
    calibrate_head(train_model, left[:, :TRAIN_H, :TRAIN_W], right[:, :TRAIN_H, :TRAIN_W])
    inp["sd_train"] = {k: v.cpu() for k, v in train_model.state_dict().items()}
    del train_model
    one = train_run(inp["sd_train"], batches, inp["lr"])
    reordered = train_run(inp["sd_train"], batches, inp["lr"], order=[2, 3, 0, 1])
    torch.cuda.empty_cache()
    # (d) references: the recipe's weights (last_3 calibrated on a crop of
    # the frame), the fp32 SGD steps in one process in order and with each
    # batch's rows swapped, and the bf16 recipe's steps in one process.
    md_model = best_sceneflow_model(LEAStereoConfig(maxdisp=MD_MAXDISP, compute_dtype="float32"), seed=MD_SEED)
    calibrate_head(md_model, left[:, :MD_H, :MD_W], right[:, :MD_H, :MD_W])
    inp["sd_md"] = {k: v.cpu() for k, v in md_model.state_dict().items()}
    del md_model
    inp["md_batches"] = [md_batch(MD_SEED + 100 + i) for i in range(MD_PARITY_STEPS)]
    md_one = train_run(inp["sd_md"], inp["md_batches"], PAR_LR, maxdisp=MD_MAXDISP)
    md_reordered = train_run(inp["sd_md"], inp["md_batches"], PAR_LR, maxdisp=MD_MAXDISP, order=[1, 0])
    md_one_bf16 = train_run(inp["sd_md"], [md_batch(MD_SEED + i) for i in range(MD_ONE_STEPS)], MD_LR,
                            maxdisp=MD_MAXDISP, dtype="bfloat16", solver="adam")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work:
        torch.save(inp, os.path.join(work, "in.pt"))
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, LOCAL_RANK="0")  # both ranks on the one card
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--rank", str(r), str(PAR_RANKS),
                                   str(port), work], env=env) for r in range(PAR_RANKS)]
        try:
            # A rank that fails would leave the other waiting in a collective.
            while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
                if time.perf_counter() - t0 > 600:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        ranks_s = time.perf_counter() - t0
        rcs = [p.returncode for p in procs]
        if any(rcs):
            raise AssertionError(f"phase 12 ranks exited {rcs}")
        outs = [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False) for r in range(PAR_RANKS)]

    zero = {k: 0 for k in counters}
    sharded = {"phase": "parallel_sharded_frame", "card": card, "shape": [1, H, W], "ranks": PAR_RANKS,
               "backend": "gloo (CUDA tensors; both ranks on the one card)", "tol_px": TOL_PAR_PX,
               "reference": "one process, pallas_head=False, fp32, TF32 off"}
    ok = True
    for md in PAR_MAXDISPS:
        errs = [(o[f"fp32_{md}"] - ref[md]).abs().max().item() for o in outs]
        errs64 = [(o[f"fp32_{md}"].double() - ref64[md]).abs().max().item() for o in outs]
        one64 = (ref[md].double() - ref64[md]).abs().max().item()
        sharded[f"maxdisp_{md}"] = {"max_abs_diff_px": errs, "disp_std": ref[md].std().item(),
                                    "sharded_vs_float64_px": errs64, "one_process_vs_float64_px": one64,
                                    "sharded_vs_ncdhw_frame_px": [(o[f"fp32_{md}"] - ref_ncdhw[md]).abs().max().item()
                                                                  for o in outs],
                                    "one_process_vs_ncdhw_frame_px": (ref[md] - ref_ncdhw[md]).abs().max().item(),
                                    "launches": [o[f"fp32_{md}_launches"] for o in outs],
                                    "peak_gb_per_rank": [o[f"fp32_{md}_peak_gb"] for o in outs]}
        ok &= all(e <= TOL_PAR_PX for e in errs) and all(o[f"fp32_{md}_launches"] == zero for o in outs)
        ok &= all(e <= one64 + TOL_PAR_PX for e in errs64)
    sharded["bf16"] = {"maxdisp": 192, "ms_per_frame": [o["bf16_ms_per_frame"] for o in outs],
                       "exchange_ms_per_frame": [o["bf16_exchange_ms_per_frame"] for o in outs],
                       "exchange_calls_per_frame": [o["bf16_exchange_calls_per_frame"] for o in outs],
                       "peak_gb_per_rank": [o["bf16_peak_gb"] for o in outs],
                       "frames": outs[0]["bf16_frames"], "launches": [o["bf16_launches"] for o in outs],
                       "finite": [o["bf16_finite"] for o in outs],
                       "note": "exchange_ms: every all_reduce of one frame (halos, head), card synchronised around each"}
    ok &= all(o["bf16_finite"] and o["bf16_launches"] == zero for o in outs)
    emit(sharded)
    if not ok:
        raise AssertionError(f"phase 12a: {sharded}")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    floor_grad = rel(reordered["grad1"], one["grad1"])
    dp_line = {"phase": "parallel_data_steps", "card": card, "shape": [TRAIN_B, TRAIN_H, TRAIN_W], "steps": PAR_STEPS,
               "ranks": PAR_RANKS, "dtype": "float32", "tf32": False, "optimizer": f"sgd {PAR_LR}, momentum 0.9",
               "one_process_losses": one["losses"], "reordered_losses": reordered["losses"],
               "rank_losses": [o["train"]["losses"] for o in outs],
               "step1_grad_rel_l2": [rel(o["train"]["grad1"], one["grad1"]) for o in outs],
               "step1_grad_rel_l2_reordered": floor_grad,
               "band_launches_per_rank": [o["train"]["launches"]["band_soft_argmin"] for o in outs],
               "one_process_band_launches": one["launches"]["band_soft_argmin"],
               "step_ms_per_rank": [o["train"]["step_ms"] for o in outs], "one_process_step_ms": one["step_ms"],
               "all_reduce_ms_last_step": [o["train"]["clock"]["ms"] for o in outs],
               "all_reduce_calls_last_step": [o["train"]["clock"]["calls"] for o in outs],
               "peak_gb_per_rank": [o["train"]["peak_gb"] for o in outs],
               "tol": {"step1_loss_rel": TOL_PAR_LOSS, "noise_factor": PAR_NOISE_FACTOR}, "ranks_seconds": ranks_s}
    ok = all(n == PAR_STEPS for n in dp_line["band_launches_per_rank"]) and dp_line["one_process_band_launches"] == PAR_STEPS
    for o in outs:
        got = o["train"]["losses"]
        ok &= abs(got[0] - one["losses"][0]) <= TOL_PAR_LOSS * abs(one["losses"][0])
        ok &= all(abs(g - w) <= PAR_NOISE_FACTOR * abs(r - w) + 1e-5 * abs(w)
                  for g, w, r in zip(got, one["losses"], reordered["losses"]))
        ok &= rel(o["train"]["grad1"], one["grad1"]) <= PAR_NOISE_FACTOR * floor_grad + 1e-6
    ok &= outs[0]["train"]["losses"] == outs[1]["train"]["losses"]
    emit(dp_line)
    if not ok:
        raise AssertionError(f"phase 12b: {dp_line}")

    # (d) the Middlebury fine-tune on the two ranks: parity against one
    # process, no head kernel, the bf16 recipe's step ms and collectives.
    from leastereo_tpu_torch.parallel import DispPartition

    mds = [(o["md_parity"], o["md_timed"]) for o in outs]
    floor_md = rel(md_reordered["grad1"], md_one["grad1"])
    md_line = {"phase": "parallel_sharded_train", "card": card, "shape": [MD_B, MD_H, MD_W], "maxdisp": MD_MAXDISP,
               "ranks": PAR_RANKS, "mesh": {"data": 1, "disp": PAR_RANKS},
               "planes_per_rank": {n: DispPartition(n, PAR_RANKS).bounds for n in (136, 68, 34)},
               "recipe": "scripts/train_md.sh: 384x576 crops, maxdisp 408, batch 2, Adam 1e-3; seeded synthetic batches",
               "parity": {"dtype": "float32", "tf32": False, "optimizer": f"sgd {PAR_LR}, momentum 0.9",
                          "steps": MD_PARITY_STEPS, "one_process_losses": md_one["losses"],
                          "reordered_losses": md_reordered["losses"], "rank_losses": [p["losses"] for p, _ in mds],
                          "step1_grad_rel_l2": [rel(p["grad1"], md_one["grad1"]) for p, _ in mds],
                          "step1_grad_rel_l2_reordered": floor_md,
                          "one_process_step_ms": md_one["step_ms"], "one_process_peak_gb": md_one["peak_gb"],
                          "step_ms_per_rank": [p["step_ms"] for p, _ in mds],
                          "peak_gb_per_rank": [p["peak_gb"] for p, _ in mds],
                          "tol": {"step1_loss_rel": TOL_PAR_LOSS, "noise_factor": PAR_NOISE_FACTOR}},
               "timed": {"dtype": "bfloat16", "optimizer": f"adam {MD_LR}", "steps": MD_TIMED_STEPS,
                         "losses_per_rank": [t["losses"] for _, t in mds],
                         "step_ms_per_rank": [t["step_ms"] for _, t in mds],
                         "median_step_ms_2_on_per_rank": [float(np.median(t["step_ms"][1:-1])) for _, t in mds],
                         "last_step_all_reduce": [t["clock"] for _, t in mds],
                         "peak_gb_per_rank": [t["peak_gb"] for _, t in mds],
                         "one_process_steps": MD_ONE_STEPS, "one_process_step_ms": md_one_bf16["step_ms"],
                         "one_process_median_step_ms_2_on": float(np.median(md_one_bf16["step_ms"][1:])),
                         "one_process_peak_gb": md_one_bf16["peak_gb"], "one_process_losses": md_one_bf16["losses"],
                         "note": "median over steps 2 to 7; step 8 runs with every all_reduce clocked (card "
                                 "synchronised around each), by the layer that called it"},
               "launches_per_rank": [{k: p["launches"][k] + t["launches"][k] for k in counters} for p, t in mds]}
    ok = all(p["launches"] == zero and t["launches"] == zero for p, t in mds)
    for p, t in mds:
        ok &= abs(p["losses"][0] - md_one["losses"][0]) <= TOL_PAR_LOSS * abs(md_one["losses"][0])
        ok &= all(abs(g - w) <= PAR_NOISE_FACTOR * abs(r - w) + 1e-5 * abs(w)
                  for g, w, r in zip(p["losses"], md_one["losses"], md_reordered["losses"]))
        ok &= rel(p["grad1"], md_one["grad1"]) <= PAR_NOISE_FACTOR * floor_md + 1e-6
        ok &= len(t["losses"]) == MD_TIMED_STEPS and all(math.isfinite(x) for x in t["losses"])
    ok &= mds[0][0]["losses"] == mds[1][0]["losses"] and mds[0][1]["losses"] == mds[1][1]["losses"]
    ok &= all("other" not in t["clock"]["kinds"] for _, t in mds)  # each all_reduce named by its layer
    ok &= all(math.isfinite(x) for x in md_one_bf16["losses"])
    emit(md_line)
    if not ok:
        raise AssertionError(f"phase 12d: {md_line}")

    # (c) NCCL, world size 1: the only NCCL one card can show. The driver
    # joins the group from the environment (--multihost); its data axis
    # reduces over the world, so sync-BN, the gradients and the metrics all
    # go through NCCL all_reduce.
    lists_dir = str(REPO / "dataloaders" / "lists")
    recipe = ["--dataset", "kitti15_part", "--data_root", KITTI_ROOT, "--listset", "kitti15_part",
              "--lists_dir", lists_dir, "--crop_height", str(TRAIN_H), "--crop_width", str(TRAIN_W),
              "--batch_size", str(TRAIN_B), "--maxdisp", "192", "--loop_mode", "n_epochs", "--ckpt_period", "0",
              "--workers", "2", "--device", "cuda", "--multihost", "--epochs", str(PAR_STEPS)]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env_keys = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0",
                "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in env_keys}
    os.environ.update(env_keys)
    clock = new_clock()
    with tempfile.TemporaryDirectory() as tmp:
        for fn in counters.values():
            fn.launches = 0
        printed = io.StringIO()
        try:
            with collective_clock(clock), contextlib.redirect_stdout(printed):
                rc = train_cli.main(recipe + ["--run_root", tmp, "--experiment", "nccl"])
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = {k: fn.launches for k, fn in counters.items()}
        exp = os.path.join(tmp, "kitti15_part-train", "nccl")
        final = os.path.exists(os.path.join(exp, "checkpoints", "final", f"{PAR_STEPS}.pth"))
        with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
            log = [json.loads(ln) for ln in f]
    n_val = len([ln for ln in log if "val_err3" in ln])
    nccl = {"phase": "parallel_nccl", "card": card, "rc": rc, "backend": "nccl", "world_size": 1,
            "steps": PAR_STEPS, "val_frames": n_val, "launches": launches, "final_checkpoint": final,
            "all_reduce_calls": clock["calls"], "all_reduce_ms": clock["ms"],
            "losses": [ln["loss"] for ln in log if "loss" in ln],
            "note": "NCCL at world size 1 is the only NCCL one card can show: NCCL refuses two ranks on one device"}
    emit(nccl)
    if not (rc == 0 and final and launches["band_soft_argmin"] == PAR_STEPS and n_val == PAR_STEPS
            and launches["fused_head_sm90"] == n_val and clock["calls"] > 0
            and all(math.isfinite(x) for x in nccl["losses"])):
        raise AssertionError(f"phase 12c: {nccl}")
    emit({"phase": "parallel_seconds", "seconds": time.perf_counter() - t_phase})
    return {"sharded_launches": [o["bf16_launches"] for o in outs],
            "dp_band_launches_per_rank": dp_line["band_launches_per_rank"], "nccl_launches": launches,
            "sharded_train_launches": md_line["launches_per_rank"]}


def frame_ms(fn, inputs, warmup: int = 3) -> list[float]:
    """Device-timeline ms of each call ``fn(l, r)`` over ``inputs`` (CUDA
    events around each frame), after ``warmup`` untimed frames."""
    for l, r in inputs[:warmup]:
        fn(l, r)
    times = []
    for l, r in inputs:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(l, r)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def export_phase(model, fp32_state: dict, counters: dict, card: str) -> dict:
    """Phase 9: ``cli.export`` of phase 4's KITTI bf16 model and of phase 6's
    fp32 model, each loaded back here and run with the counts zeroed just
    before; the loaded programs against the eager models; a trace of one
    loaded frame; the model's FLOPs. Returns each kernel's launches in the
    loaded programs' frames."""
    from torch.autograd import DeviceType

    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
    from leastereo_tpu_torch.utils.profiling import model_flops, peak_hbm_gb
    from leastereo_tpu_torch.utils.tracing import trace

    dev = next(model.parameters()).device
    fp32_model = best_sceneflow_model(LEAStereoConfig(maxdisp=48, compute_dtype="float32"))
    fp32_model.load_state_dict(fp32_state)
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as in the export driver's process
    rng = np.random.RandomState(9)
    # (run, eager model, driver flags, (H, W), the head each frame must
    # launch, frames, its kernel's name in a trace)
    runs = (("kitti_bf16", model, ["--height", str(CLI_H), "--width", str(CLI_W)], (CLI_H, CLI_W),
             "fused_head_sm90", EXPORT_FRAMES, "head_sm90_kernel"),
            ("fp32_96x192", fp32_model, ["--dtype", "float32", "--height", "96", "--width", "192", "--maxdisp", "48"],
             (96, 192), "fused_head_sm90_f32", EXPORT_FP32_FRAMES, "head_sm90_f32_kernel"))
    export_launches = {k: 0 for k in counters}
    result = {"phase": "export", "card": card, "tol_px": TOL_EXPORT_PX}
    with tempfile.TemporaryDirectory() as tmp:
        for run, eager, flags, (H, W), head, frames, kernel_name in runs:
            ckpt, out = os.path.join(tmp, f"{run}.pth"), os.path.join(tmp, f"{run}.pt2")
            torch.save(eager.state_dict(), ckpt)
            argv = [sys.executable, "-m", "leastereo_tpu_torch.cli.export", *flags, "--checkpoint", ckpt, "--out", out]
            t0 = time.perf_counter()
            proc = subprocess.run(argv, capture_output=True, text=True, cwd=REPO, timeout=600)
            driver_s = time.perf_counter() - t0
            if proc.returncode != 0 or "round-trip check passed" not in proc.stdout:
                raise AssertionError(f"export {run}: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-6000:]}")
            t0 = time.perf_counter()
            prog = torch.export.load(out).module()
            load_s = time.perf_counter() - t0
            inputs = [tuple(torch.from_numpy(rng.randn(1, H, W, 3).astype(np.float32)).to(dev) for _ in range(2))
                      for _ in range(frames)]
            for fn in counters.values():
                fn.launches = 0
            with torch.inference_mode():
                got = [prog(l, r) for l, r in inputs]
                torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items()}
            for k, n in launches.items():
                export_launches[k] += n
            with torch.inference_mode():
                diff = max((g.float() - eager(l, r).float()).abs().max().item() for g, (l, r) in zip(got, inputs))
                prog_ms = frame_ms(prog, inputs)
                eager_ms = frame_ms(eager, inputs)
            line = {"driver_argv": flags, "driver_seconds": driver_s, "driver_stdout_last": proc.stdout.strip().splitlines()[-1],
                    "pt2_bytes": os.path.getsize(out), "load_seconds": load_s, "frames": frames, "launches": launches,
                    "max_abs_diff_vs_eager_px": diff, "loaded_frame_ms_median": float(np.median(prog_ms)),
                    "eager_frame_ms_median": float(np.median(eager_ms)), "loaded_frame_ms": prog_ms, "eager_frame_ms": eager_ms}
            result[run] = line
            if launches != {k: (frames if k == head else 0) for k in counters} or not diff <= TOL_EXPORT_PX:
                emit(result)
                raise AssertionError(f"loaded {run} program: launches {launches} (expected {frames} of {head} only), "
                                     f"{diff} px from the eager model")
            # The device's own record that the loaded program runs the hand
            # kernel; one eager frame traced the same way beside it (device
            # ms and host aten calls per frame).
            for label, fn in (("loaded", prog), ("eager", eager)):
                with torch.inference_mode(), trace(os.path.join(tmp, f"trace_{run}_{label}")) as prof:
                    fn(*inputs[0])
                events = prof.key_averages()
                line[f"{label}_trace_device_ms"] = sum(
                    e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
                line[f"{label}_trace_aten_calls"] = sum(
                    e.count for e in events if e.device_type == DeviceType.CPU and e.key.startswith("aten::"))
                if label == "loaded":
                    head_events = [e for e in events if kernel_name in e.key]
            trace_text = pathlib.Path(tmp, f"trace_{run}_loaded", "trace.json").read_text()
            line["trace_kernel"] = kernel_name
            line["trace_names_kernel"] = kernel_name in trace_text
            line["trace_kernel_device_ms"] = sum(e.self_device_time_total for e in head_events) / 1e3
            if not (line["trace_names_kernel"] and line["trace_kernel_device_ms"] > 0):
                emit(result)
                raise AssertionError(f"the trace of a loaded {run} frame does not show {kernel_name}")
            del prog, got, inputs
        # FLOPs of one KITTI bf16 frame (torch's counter: convolutions and the
        # fused head's formula), equal with the head unfused.
        l, r = (torch.from_numpy(rng.randn(1, CLI_H, CLI_W, 3).astype(np.float32)).to(dev) for _ in range(2))
        plain = best_sceneflow_model(LEAStereoConfig(maxdisp=192, compute_dtype="bfloat16", pallas_head=False))
        plain.load_state_dict(model.state_dict())
        with torch.inference_mode():
            flops, flops_plain = model_flops(model, l, r), model_flops(plain, l, r)
        del plain
    result.update({"kitti_bf16_frame_flops": flops, "kitti_bf16_frame_flops_unfused_head": flops_plain,
                   "peak_hbm_gb": peak_hbm_gb(dev), "export_launches": export_launches,
                   "note": "flops count convolutions only (torch.utils.flop_counter); frame ms: CUDA events per frame"})
    emit(result)
    if flops != flops_plain or not flops > 0:
        raise AssertionError(f"FLOPs differ with the head fused ({flops}) and not ({flops_plain})")
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    return export_launches


def conv3d_classes_phase(card: str) -> list:
    """The matching net's 3x3x3 classes at a Middlebury and a KITTI frame's
    shapes (seeded bf16 inputs): the sm90 kernel (where the gate admits the
    class) against its plain version's fp32 sums within one bf16 rounding,
    then, in turns (kernel, fused, fused, kernel; best of two), its ms beside
    cuDNN's fused call as the port made it before the kernel, the plain
    version's ms, cuDNN's own pick with ``torch.backends.cudnn.benchmark`` on
    (inside this phase only; the port never sets it) and the bound. One
    ``conv3d_class`` line a class; raises on a kernel outside the bound."""
    from leastereo_tpu_torch.ops.conv3d import conv3d_bias_relu_plain, conv3d_bias_relu_sm90, conv3d_sm90_admits
    from leastereo_tpu_torch.ops.convbr import conv_bias_relu_cudnn

    dev, cl = torch.device("cuda"), torch.channels_last_3d
    rows = []
    for frame, cin, cout, dhw, calls in CONV3D_CLASSES:
        gen = torch.Generator(device=dev).manual_seed(cin + dhw[0])
        x = torch.relu(torch.randn(1, cin, *dhw, generator=gen, device=dev)).to(torch.bfloat16).contiguous(
            memory_format=cl)
        w = (torch.randn(cout, cin, 3, 3, 3, generator=gen, device=dev) / (27 * cin) ** 0.5).to(
            torch.bfloat16, memory_format=cl)
        b = (0.3 * torch.randn(cout, generator=gen, device=dev)).to(torch.bfloat16)
        voxels = math.prod(dhw)
        lim = bound(voxels * (cin + cout) * 2 + w.numel() * 2, 2 * 27 * cin * cout * voxels, torch.bfloat16, 0)
        fns = {"fused": lambda: conv_bias_relu_cudnn(x, w, b, [1] * 3, [1] * 3)}
        row = {"phase": "conv3d_class", "card": card, "frame": frame, "cin": cin, "cout": cout, "dhw": list(dhw),
               "calls_per_frame": calls, "admitted": conv3d_sm90_admits(x, w, b, True, (1, 1, 1), (1, 1, 1)),
               "bound_ms": lim[0], "bound_by": lim[1]}
        if row["admitted"]:
            fns["sm90"] = lambda: conv3d_bias_relu_sm90(x, w, b)
            got = fns["sm90"]()
            exact = torch.relu(F.conv3d(x.float(), w.float(), b.float(), padding=1))
            err = (got.float() - exact).abs_()
            row["max_abs_err"] = err.max().item()
            row["within_one_rounding"] = bool((err <= 2 ** -8 * exact.abs() + 1e-5 * exact.abs().max()).all())
            del got, exact, err
        turns = {k: [] for k in fns}
        for key in ("sm90", "fused", "fused", "sm90"):
            if key in fns:
                turns[key].append(cuda_ms(fns[key], iters=10))
        row.update({f"{k}_ms": min(v) for k, v in turns.items()})
        row["plain_ms"] = cuda_ms(lambda: conv3d_bias_relu_plain(x, w, b), iters=3, warmup=1)
        torch.backends.cudnn.benchmark = True
        try:
            row["cudnn_benchmark_ms"] = cuda_ms(fns["fused"], iters=10)
        finally:
            torch.backends.cudnn.benchmark = False
        if row["admitted"]:
            row["share_of_bound"] = lim[0] / row["sm90_ms"]
            row["sm90_over_fused"] = row["sm90_ms"] / row["fused_ms"]
        emit(row)
        rows.append(row)
        del x, w, b
        torch.cuda.empty_cache()
    bad = [r for r in rows if r["admitted"] and not r["within_one_rounding"]]
    if bad:
        raise AssertionError(f"sm90 3x3x3 convolution outside one bf16 rounding: {bad}")
    return rows


def ndhwc_counters() -> dict:
    """The launch counters of the NDHWC kernels (``csrc/ndhwc.cu``), by kernel."""
    from leastereo_tpu_torch.ops.fused_stem import stem_ndhwc_cuda
    from leastereo_tpu_torch.ops.layout import cat_ndhwc_cuda
    from leastereo_tpu_torch.ops.resize import resize3d_ndhwc_cuda

    return {"stem_ndhwc": stem_ndhwc_cuda, "cat_ndhwc": cat_ndhwc_cuda, "resize_ndhwc": resize3d_ndhwc_cuda}


def ndhwc_frame_check(model, left, right, label: str, card: str) -> dict:
    """One eval frame of ``model`` in which every call of an NDHWC kernel is
    held bit for bit against its plain version on the same input and timed
    beside it (CUDA events, 5 calls each): the stem kernel inside the fused
    stem (plain: the fused stem's NCDHW PyTorch gathers, then one conversion
    to NDHWC), the concat (``torch.cat``) and the resize (``F.interpolate``;
    the last resize writes NCDHW). Per kernel, summed over the frame: calls,
    unequal outputs, the largest difference, ms, library_ms (the plain
    version's), bound_ms (its bytes at the memory rate). Raises on any
    difference or a wrong layout."""
    from unittest import mock

    import leastereo_tpu_torch.models.matching_net as mn
    from leastereo_tpu_torch.ops import fused_stem, layout, resize

    stats = {k: {"calls": 0, "unequal": 0, "wrong_layout": 0, "max_abs_diff": 0.0, "ms": 0.0, "library_ms": 0.0,
                 "bound_ms": 0.0, "shapes": []} for k in NDHWC_CALLS}
    timed_stem = {}

    def record(name, got, want, fmt, run, plain, nbytes):
        st = stats[name]
        st["calls"] += 1
        st["unequal"] += int(not torch.equal(got, want))
        st["wrong_layout"] += int(not got.is_contiguous(memory_format=fmt))
        st["max_abs_diff"] = max(st["max_abs_diff"], (got.float() - want.float()).abs().max().item())
        st["ms"] += cuda_ms(run, iters=5, warmup=1)
        st["library_ms"] += cuda_ms(plain, iters=5, warmup=1)
        st["bound_ms"] += bound(nbytes, 0, got.dtype, 0)[0]
        st["shapes"].append(list(got.shape))

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    stem_kernel, stem, cat_kernel, resize_kernel = (
        fused_stem.stem_ndhwc_cuda, mn.fused_cost_volume_stem, layout.cat_ndhwc_cuda, resize.resize3d_ndhwc_cuda)

    def stem_kernel_timed(*args):
        out = stem_kernel(*args)
        timed_stem["run"], timed_stem["bytes"] = (lambda: stem_kernel(*args)), nbytes(out, *args[:3])
        return out

    def stem_checked(left_f, right_f, kernel, num_disp, **kw):
        got = stem(left_f, right_f, kernel, num_disp, **kw)
        plain_kw = dict(kw, memory_format=torch.contiguous_format)

        def plain():
            return stem(left_f, right_f, kernel, num_disp, **plain_kw).contiguous(memory_format=torch.channels_last_3d)

        record("stem_ndhwc", got, plain(), torch.channels_last_3d, timed_stem["run"], plain, timed_stem["bytes"])
        library = stats["stem_ndhwc"]
        library["fused_stem_ms"] = library.get("fused_stem_ms", 0.0) + cuda_ms(
            lambda: stem(left_f, right_f, kernel, num_disp, **kw), iters=5, warmup=1)
        return got

    def cat_checked(xs):
        got = cat_kernel(xs)
        record("cat_ndhwc", got, torch.cat(xs, dim=1), torch.channels_last_3d, lambda: cat_kernel(xs),
               lambda: torch.cat(xs, dim=1), 2 * nbytes(got))
        return got

    def resize_checked(x, out_dhw, memory_format=torch.channels_last_3d):
        got = resize_kernel(x, out_dhw, memory_format)

        def plain():
            return F.interpolate(x, size=tuple(out_dhw), mode="trilinear", align_corners=True)

        record("resize_ndhwc", got, plain(), memory_format, lambda: resize_kernel(x, out_dhw, memory_format), plain,
               nbytes(x, got))
        return got

    # The kernels' wrappers count their launches under their module names,
    # which resolve to these stand-ins while they are patched in.
    for fn in (stem_kernel_timed, cat_checked, resize_checked):
        fn.launches = 0
    with (mock.patch.object(fused_stem, "stem_ndhwc_cuda", stem_kernel_timed),
          mock.patch.object(mn, "fused_cost_volume_stem", stem_checked),
          mock.patch.object(layout, "cat_ndhwc_cuda", cat_checked),
          mock.patch.object(resize, "resize3d_ndhwc_cuda", resize_checked), torch.inference_mode()):
        disp = model(left, right)
        torch.cuda.synchronize()
    line = {"phase": "ndhwc_kernels", "card": card, "frame": label, "shape": [1, *left.shape[1:3]],
            "maxdisp": model.config.maxdisp, "dtype": model.config.compute_dtype,
            "finite": bool(torch.isfinite(disp).all()), **stats,
            "note": "each call against its plain version on the same input; ms, library_ms, bound_ms summed over "
                    "the frame's calls (CUDA events, 5 calls each); stem library_ms: the fused stem's NCDHW "
                    "gathers and one conversion to NDHWC, against the kernel alone (fused_stem_ms: the whole "
                    "NDHWC fused stem)"}
    emit(line)
    bad = {k: st for k, st in stats.items()
           if st["calls"] != NDHWC_CALLS[k] or st["unequal"] or st["wrong_layout"] or st["max_abs_diff"] != 0.0}
    if bad or not line["finite"]:
        raise AssertionError(f"NDHWC kernels at {label}: {line}")
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card only", file=sys.stderr)
        return 2

    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
    from leastereo_tpu_torch.ops import _build
    from leastereo_tpu_torch.ops.fused_head import (
        ROUTE_WRAPPERS,
        conv_soft_argmin_reference,
        conv_soft_argmin_sm90,
        conv_soft_argmin_sm90_f32,
    )
    from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda
    from leastereo_tpu_torch.ops.softargmin import soft_argmin

    dev = torch.device("cuda")
    counters = head_counters()

    def zero_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {k: fn.launches for k, fn in counters.items()}
    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False, "note": "TF32 off for cuDNN and matmul: fp32 phases run in full fp32"})

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load_kernels()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines() if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s,
          "built": list(counters),
          "sources": [SRC_SM90, SRC_HEADS, SRC_NDHWC, SRC_CONV3D], "ptxas": ptxas})

    # ---- 3. kernels against their plain versions at the main path's shapes
    # (utils/kernel_parity.py: each kernel against float64 on peaky, wide and
    # diffuse inputs)
    b, c, d, h, w, maxdisp = (kernel_parity.KITTI[k] for k in ("b", "c", "d", "h", "w", "maxdisp"))
    gen = torch.Generator(device=dev).manual_seed(0)
    parity = (kernel_parity.head_checks(gen, b, c, d, h, w, maxdisp, dev)
              + kernel_parity.band_checks(gen, b, d, h, w, maxdisp, dev))
    for check in parity:
        emit_check(check)
    errs = {name: max(c["max_abs_err"] for c in parity if c["kernel"] == name)
            for name, *_ in kernel_parity.HEAD_ROUTES}
    band_err = max(c["max_abs_err"] for c in parity if c["kernel"] == "band_soft_argmin")

    # A 300x cost (a span of thousands of units): the kernels and the fp32
    # plain versions, each against float64. Measured, not held to
    # TOL_KERNEL_PX: fp32 rounding of the cost (the conv's sum, the blends)
    # moves near-tied minima that lie far apart, and fp32 plain code errs
    # as much.
    wide = {}
    v300, k300 = head_inputs(gen, "peaky", b, c, d, h, w, dev)
    v300, k300 = v300.to(torch.bfloat16), SPAN_300 * k300
    ref = conv_soft_argmin_reference(v300.double(), k300.double(), maxdisp)
    wide["fused_head_sm90"] = (conv_soft_argmin_sm90(v300, k300, maxdisp).double() - ref).abs().max().item()
    # The fp32 kernel on the same values (the bf16 volume's, in fp32), as the plain fp32 version.
    wide["fused_head_sm90_f32"] = (conv_soft_argmin_sm90_f32(v300.float(), k300, maxdisp).double() - ref).abs().max().item()
    wide["fused_head_plain_fp32"] = (conv_soft_argmin_reference(v300.float(), k300, maxdisp).double() - ref).abs().max().item()
    c300 = SPAN_300 * peaky_cost(gen, b, d, h, w, dev)
    ref = soft_argmin(c300.double(), maxdisp)
    wide["band_soft_argmin"] = (soft_argmin_cuda(c300, maxdisp).double() - ref).abs().max().item()
    wide["band_plain_fp32"] = (soft_argmin(c300, maxdisp).double() - ref).abs().max().item()
    emit({"phase": "wide_span_300x", "max_abs_err_px": wide})
    del v300, c300, ref

    vol32, kern = head_inputs(gen, "diffuse", b, c, d, h, w, dev)  # the timed inputs
    cost = kernel_parity.band_cost(gen, "diffuse", b, d, h, w, dev)
    vol = vol32.to(torch.bfloat16)  # main path: bf16 volume
    kern16 = kern.to(torch.bfloat16)
    # The bf16 and fp32 TMA heads beside their unfused yardsticks (cuDNN
    # last_3 in the volume's type, TF32 off, then the band kernel; the port
    # does not run this pair on this route), in turns, best of two each.
    unfused = lambda: soft_argmin_cuda(F.conv3d(vol, kern16, padding=1)[:, 0].float(), maxdisp)
    unfused32 = lambda: soft_argmin_cuda(F.conv3d(vol32, kern, padding=1)[:, 0], maxdisp)
    fns = {"sm90": lambda: conv_soft_argmin_sm90(vol, kern, maxdisp), "unfused": unfused,
           "sm90_f32": lambda: conv_soft_argmin_sm90_f32(vol32, kern, maxdisp), "unfused_fp32": unfused32}
    turns = {key: [] for key in fns}
    for key in ("sm90", "unfused", "unfused", "sm90", "sm90_f32", "unfused_fp32", "unfused_fp32", "sm90_f32"):
        turns[key].append(cuda_ms(fns[key]))
    sm90_ms, unfused_ms, sm90_f32_ms, unfused32_ms = (min(turns[k]) for k in fns)
    sm90_bf16w_ms = cuda_ms(lambda: conv_soft_argmin_sm90(vol, kern16, maxdisp))
    head_plain_ms = cuda_ms(lambda: conv_soft_argmin_reference(vol, kern, maxdisp), iters=5)
    head_fp32_plain_ms = cuda_ms(lambda: conv_soft_argmin_reference(vol32, kern, maxdisp), iters=5)
    band_ms = cuda_ms(lambda: soft_argmin_cuda(cost, maxdisp))
    band_plain_ms = cuda_ms(lambda: soft_argmin(cost, maxdisp), iters=5)
    out_bytes = b * 9 * h * w * 4
    exps = b * 9 * h * w * d  # one per low-res plane and output phase
    head_flops = 2 * 27 * c * b * d * h * w
    head_bound = bound(vol.numel() * 2 + kern.numel() * 4 + out_bytes, head_flops, torch.bfloat16, exps)
    head_fp32_bound = bound(vol32.numel() * 4 + kern.numel() * 4 + out_bytes, head_flops, torch.float32, exps)
    band_bound = bound(cost.numel() * 4 + out_bytes, 0, torch.float32, exps)
    emit({"phase": "kernel_times", "card": card, "fused_head_sm90_ms": sm90_ms,
          "fused_head_sm90_bf16_weights_ms": sm90_bf16w_ms, "unfused_ms": unfused_ms,
          "fused_head_plain_ms": head_plain_ms, "fused_head_bound_ms": head_bound[0],
          "band_ms": band_ms, "band_plain_ms": band_plain_ms, "band_bound_ms": band_bound[0],
          "band_bound_by": band_bound[1], "exponentials": exps,
          "fused_head_sm90_f32_ms": sm90_f32_ms, "fused_head_sm90_f32_stages": _build.head_sm90_f32_stages(c, d),
          "fused_head_sm90_f32_smem_bytes": _build.head_sm90_f32_smem_bytes(c, d), "unfused_fp32_ms": unfused32_ms,
          "turns_ms": turns, "fused_head_fp32_volume_plain_ms": head_fp32_plain_ms,
          "fused_head_fp32_volume_bound_ms": head_fp32_bound[0], "fused_head_fp32_volume_bound_by": head_fp32_bound[1],
          "fused_head_sm90_f32_share_of_bound": head_fp32_bound[0] / sm90_f32_ms,
          "fp32_volume_mb": vol32.numel() * 4 / 1e6, "peak_bytes_s": PEAK_BYTES_S,
          "note": "ms: best of two turns (sm90, unfused, unfused, sm90, sm90_f32, unfused fp32, unfused fp32, "
                  "sm90_f32); fused heads take the fp32 kernel, the unfused bf16 cuDNN conv its bf16 rounding, the "
                  "unfused fp32 one runs with TF32 off"})
    if not sm90_ms < unfused_ms / 2 or not sm90_f32_ms < unfused32_ms / 2:
        raise AssertionError(f"TMA heads {sm90_ms}, {sm90_f32_ms} ms are not twice as fast as their yardsticks "
                             f"{unfused_ms}, {unfused32_ms} ms")

    # The band kernel's grid at KITTI against the card's resident-block slots.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    band_blocks = b * -(-h // _build.BAND_TILE_H) * -(-w // _build.BAND_TILE_W)
    band_per_sm = _build.load_kernels().lst_band_blocks_per_sm(d)
    emit({"phase": "band_grid", "card": card, "tile": [_build.BAND_TILE_H, _build.BAND_TILE_W],
          "blocks": band_blocks, "blocks_per_sm": band_per_sm, "slots": band_per_sm * sms,
          "waves": band_blocks / (band_per_sm * sms), "smem_bytes": _build.band_smem_bytes(d)})
    if band_per_sm < 1:
        raise AssertionError(f"band kernel occupancy query failed: {band_per_sm}")

    # The routes at the shapes the first design alone took before (padded
    # and grouped channels, rows TMA cannot read in place, an unaligned base): each
    # against float64 on peaky, wide and diffuse inputs, then timed in turns
    # with its yardstick on the diffuse one.
    routes = route_shapes_phase(gen, maxdisp, dev, card)

    # Where the body's time goes: the padded channels' cost (the C = 24
    # volume against the C = 32 one, both in place) and the repitch copy's
    # (the repitch routes forced on the KITTI volumes the in-place routes
    # read), in turns, best of two.
    v24 = vol[:, :24].contiguous()
    k24 = kern[:, :24].contiguous()
    fns = {"c32_tma": lambda: conv_soft_argmin_sm90(vol, kern, maxdisp),
           "c24_tma": lambda: conv_soft_argmin_sm90(v24, k24, maxdisp),
           "c32_repitch": lambda: ROUTE_WRAPPERS["sm90_repitch"](vol, kern, maxdisp),
           "c32_f32_tma": lambda: conv_soft_argmin_sm90_f32(vol32, kern, maxdisp),
           "c32_f32_repitch": lambda: ROUTE_WRAPPERS["sm90_f32_repitch"](vol32, kern, maxdisp)}
    prof = {key: [] for key in fns}
    for key in ("c32_tma", "c24_tma", "c32_repitch", "c32_f32_tma", "c32_f32_repitch",
                "c32_f32_repitch", "c32_f32_tma", "c32_repitch", "c24_tma", "c32_tma"):
        prof[key].append(cuda_ms(fns[key]))
    best = {k: min(v) for k, v in prof.items()}
    emit({"phase": "head_profile", "card": card, "shape": [b, c, d, h, w], "ms": best, "turns_ms": prof,
          "padded_channels_c24_over_c32": best["c24_tma"] / best["c32_tma"],
          "bytes_c24_over_c32": 24 / 32,
          "repitch_over_in_place_bf16": best["c32_repitch"] / best["c32_tma"],
          "repitch_over_in_place_fp32": best["c32_f32_repitch"] / best["c32_f32_tma"],
          "sm90_dram_gb_s": (vol.numel() * 2 + out_bytes) / best["c32_tma"] / 1e6,
          "sm90_repitch_dram_gb_s": (vol.numel() * 2 + out_bytes) / best["c32_repitch"] / 1e6})
    del vol32, vol, cost, v24
    torch.cuda.empty_cache()

    # The matching net's 3x3x3 convolution classes: the sm90 kernel against
    # cuDNN (fused as the port called it before, and its benchmark pick).
    conv_rows = conv3d_classes_phase(card)

    # ---- 4. main path at KITTI
    H, W = 384, 1248
    rng = np.random.RandomState(0)
    left = torch.from_numpy(rng.randn(1, H, W, 3).astype(np.float32)).to(dev)
    right = torch.from_numpy(rng.randn(1, H, W, 3).astype(np.float32)).to(dev)
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="bfloat16"), seed=0)
    calibrate_head(model, left, right)
    # The in-model fused path (utils/kernel_parity.py): the model's map
    # against float64 on the volume and kernel it hands its head.
    for check in kernel_parity.in_model_checks(model, left, right):
        emit_check(check)
    # The confidence forward: the band kernel, once.
    model_conf = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="bfloat16", return_entropy=True))
    model_conf.load_state_dict(model.state_dict())
    zero_counts()
    with torch.inference_mode():
        disp_conf, ent = model_conf(left, right)
        torch.cuda.synchronize()
    launches = read_counts()
    emit({"phase": "confidence_forward", "card": card, "shape": [1, H, W], "maxdisp": maxdisp, "dtype": "bfloat16",
          "launches": launches, "entropy_finite": bool(torch.isfinite(ent).all())})
    if not (tuple(ent.shape) == (1, H, W) and bool(torch.isfinite(ent).all()) and tuple(disp_conf.shape) == (1, H, W)
            and launches == {k: int(k == "band_soft_argmin") for k in counters}):
        raise AssertionError(f"confidence forward: launches {launches}, entropy {tuple(ent.shape)}")
    del model_conf, disp_conf, ent

    # The NDHWC kernels at every call of a KITTI and a Middlebury frame
    # against their plain versions, bit for bit, and timed beside them.
    ndhwc_check = {"kitti": ndhwc_frame_check(model, left, right, "kitti", card)}
    md_rng = np.random.RandomState(4)
    md_left, md_right = (torch.from_numpy(md_rng.randn(1, *MD_FRAME[:2], 3).astype(np.float32)).to(dev)
                         for _ in range(2))
    md_model = best_sceneflow_model(LEAStereoConfig(maxdisp=MD_FRAME[2], compute_dtype="bfloat16"), seed=0)
    ndhwc_check["middlebury"] = ndhwc_frame_check(md_model, md_left, md_right, "middlebury", card)
    del md_model, md_left, md_right
    torch.cuda.empty_cache()

    # ---- 5. profile: the device time of three KITTI bf16 frames by kernel
    # kind, after one untraced frame; the launches over the four frames, for
    # the kernel table (tests/test_torch_cuda.py holds them to a frame's).
    # Device-side events only (kernels, copies): operator events carry their
    # kernels' time as well and would count it twice.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from leastereo_tpu_torch.ops.conv3d import conv3d_bias_relu_sm90

    ndhwc = ndhwc_counters()
    zero_counts()
    for fn in (*ndhwc.values(), conv3d_bias_relu_sm90):
        fn.launches = 0
    with torch.inference_mode():
        model(left, right)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(left, right)
            torch.cuda.synchronize()
    default_frames = 4
    default_launches = read_counts()
    ndhwc_launches = {k: fn.launches for k, fn in ndhwc.items()}
    conv3d_launches = conv3d_bias_relu_sm90.launches
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    emit({"phase": "frame_profile", "card": card, "shape": [1, H, W], "maxdisp": maxdisp, "dtype": "bfloat16",
          "frames": default_frames, "launches": default_launches, "ndhwc_launches": ndhwc_launches,
          "conv3d_sm90_launches": conv3d_launches,
          "device_ms_per_frame": sum(e.self_device_time_total for e in events) / 1e3 / 3,
          "device_ms_per_frame_by_kind": by_kind(events, 3),
          "top_kernels_ms_per_frame": [[e.key[:100], e.self_device_time_total / 1e3 / 3]
                                       for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]]})

    # Four fp32 KITTI frames (the fp32 sm90 head's case), the last three
    # under the profiler, with cuDNN's TF32 on as PyTorch's default gives a
    # user: device time by kind and the fp32 sm90 head's share of it.
    model32 = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="float32"))
    model32.load_state_dict(model.state_dict())
    torch.backends.cudnn.allow_tf32 = True
    zero_counts()
    with torch.inference_mode():
        model32(left, right)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof32:
            for _ in range(3):
                model32(left, right)
            torch.cuda.synchronize()
    fp32_frame_launches = read_counts()
    torch.backends.cudnn.allow_tf32 = False
    events32 = [e for e in prof32.key_averages() if e.device_type == DeviceType.CUDA]
    fp32_frame_ms = sum(e.self_device_time_total for e in events32) / 1e3 / 3
    fp32_head_frame_ms = sum(e.self_device_time_total for e in events32 if "head_sm90_f32_kernel" in e.key) / 1e3 / 3
    emit({"phase": "fp32_frame", "card": card, "shape": [1, H, W], "maxdisp": maxdisp, "dtype": "float32",
          "cudnn_tf32": True, "frames": 4, "device_ms_per_frame": fp32_frame_ms,
          "fused_head_sm90_f32_ms_per_frame": fp32_head_frame_ms,
          "fused_head_sm90_f32_share": fp32_head_frame_ms / fp32_frame_ms, "launches": fp32_frame_launches,
          "device_ms_per_frame_by_kind": by_kind(events32, 3)})
    if fp32_frame_launches != {k: 4 if k == "fused_head_sm90_f32" else 0 for k in counters} or not fp32_head_frame_ms > 0:
        raise AssertionError(f"fp32 KITTI frames: launches {fp32_frame_launches} in 4 frames, "
                             f"fp32 sm90 head {fp32_head_frame_ms} ms a frame")
    del model32
    torch.cuda.empty_cache()

    # ---- 6. whole model, kernel path vs plain path, fp32, reduced size
    hs, ws, md = 96, 192, 48
    left_s = torch.from_numpy(rng.randn(1, hs, ws, 3).astype(np.float32)).to(dev)
    right_s = torch.from_numpy(rng.randn(1, hs, ws, 3).astype(np.float32)).to(dev)
    results = {}
    zero_counts()
    kern_model = best_sceneflow_model(LEAStereoConfig(maxdisp=md, compute_dtype="float32"), seed=1)
    calibrate_head(kern_model, left_s, right_s)
    state = kern_model.state_dict()
    for entropy in (False, True):
        k_model = best_sceneflow_model(LEAStereoConfig(maxdisp=md, compute_dtype="float32", return_entropy=entropy))
        p_model = best_sceneflow_model(
            LEAStereoConfig(maxdisp=md, compute_dtype="float32", return_entropy=entropy, pallas_head=False))
        k_model.load_state_dict(state)
        p_model.load_state_dict(state)
        n_head, n_band = conv_soft_argmin_sm90_f32.launches, soft_argmin_cuda.launches
        with torch.inference_mode():
            got, ref = k_model(left_s, right_s), p_model(left_s, right_s)
        if entropy:
            got, ref = got[0], ref[0]
        used = "band_soft_argmin" if soft_argmin_cuda.launches > n_band else (
            "fused_head_sm90_f32" if conv_soft_argmin_sm90_f32.launches > n_head else None)
        results["return_entropy" if entropy else "default"] = {
            "kernel": used, "max_abs_diff_px": (got - ref).abs().max().item(), "disp_std": ref.std().item()}
    fp32_launches = read_counts()  # the default forward's head and the entropy forward's band kernel
    emit({"phase": "model_kernel_vs_plain", "shape": [1, hs, ws], "maxdisp": md, "dtype": "float32",
          "tol_px": TOL_MODEL_PX, "launches": fp32_launches, **results})
    if fp32_launches != {k: int(k in ("fused_head_sm90_f32", "band_soft_argmin")) for k in counters}:
        raise AssertionError(f"fp32 default forward launched {fp32_launches}")
    for name, r in results.items():
        if r["kernel"] is None or not r["max_abs_diff_px"] < TOL_MODEL_PX:
            raise AssertionError(f"whole model {name}: {r}")

    # The padded-channel path: the fp32 model with a 24-channel matching net
    # (mat_filter_multiplier 6, as a user's own search or training may give),
    # whose volume the fp32 TMA route takes with its channels padded to 32;
    # kernel path against plain path as above, counts zeroed just before and
    # read just after.
    cfg24 = {"maxdisp": md, "compute_dtype": "float32", "mat_filter_multiplier": 6}
    k24 = best_sceneflow_model(LEAStereoConfig(**cfg24), seed=3)
    calibrate_head(k24, left_s, right_s)
    p24 = best_sceneflow_model(LEAStereoConfig(**cfg24, pallas_head=False))
    p24.load_state_dict(k24.state_dict())
    zero_counts()
    with torch.inference_mode():
        got24 = k24(left_s, right_s)
        torch.cuda.synchronize()
    padded_launches = read_counts()
    with torch.inference_mode():
        padded_err = (got24 - p24(left_s, right_s)).abs().max().item()
    padded_path = {"phase": "padded_channels_path", "card": card, "shape": [1, hs, ws], "maxdisp": md,
                   "dtype": "float32", "mat_filter_multiplier": 6, "channels": 24,
                   "entry_channels": _build.head_sm90_entry_channels(24), "launches": padded_launches,
                   "max_abs_diff_px": padded_err, "tol_px": TOL_MODEL_PX, "disp_std": got24.std().item()}
    emit(padded_path)
    if padded_launches != {k: int(k == "fused_head_sm90_f32") for k in counters} or not padded_err < TOL_MODEL_PX:
        raise AssertionError(f"padded-channel path: {padded_path}")
    del k24, p24, got24

    # The repitch routes' path: a model's volume is always read in place
    # (its matching net needs w, the width at 1/3 resolution, to be a
    # multiple of 8), so these routes serve callers of the op on volumes TMA
    # cannot read in place. The op torch.ops.leastereo.conv_soft_argmin on
    # the route shapes w412 and unaligned (bf16) and w414_f32 (fp32), peaky
    # inputs, counts zeroed just before and read just after, each against the
    # plain path in float64.
    op_inputs = []
    for name in ("w412", "unaligned", "w414_f32"):
        shape, dtype_name, offset = kernel_parity.ROUTE_SHAPES[name]
        vol_o, kern_o = head_inputs(gen, "peaky", *shape, dev)
        op_inputs.append((name, kernel_parity.offset_copy(vol_o.to(getattr(torch, dtype_name)), offset), kern_o))
        del vol_o
    zero_counts()
    with torch.inference_mode():
        op_out = [torch.ops.leastereo.conv_soft_argmin(v, k, maxdisp) for _, v, k in op_inputs]
        torch.cuda.synchronize()
    op_launches = read_counts()
    op_errs = {}
    for (name, v, k), got in zip(op_inputs, op_out):
        op_errs[name] = (got.double() - conv_soft_argmin_reference(v.double(), k.double(), maxdisp)).abs().max().item()
    op_path = {"phase": "repitch_op_path", "card": card, "entry": "torch.ops.leastereo.conv_soft_argmin",
               "shapes": [n for n, *_ in op_inputs], "launches": op_launches, "max_abs_err_px": op_errs,
               "tol_px": TOL_KERNEL_PX}
    emit(op_path)
    if (op_launches != {k: {"fused_head_sm90_repitch": 2, "fused_head_sm90_f32_repitch": 1}.get(k, 0) for k in counters}
            or not max(op_errs.values()) < TOL_KERNEL_PX):
        raise AssertionError(f"repitch op path: {op_path}")
    del op_inputs, op_out
    torch.cuda.empty_cache()

    # ---- 7. a cost the kernels refuse raises on the card: maxdisp 50 gives
    # D = 16 != 50 / 3, so the fused head falls to the band kernel, whose
    # wrapper raises rather than run the plain version.
    bad_model = best_sceneflow_model(LEAStereoConfig(maxdisp=md + 2, compute_dtype="float32"))
    counts = read_counts()
    refusal = None
    with torch.inference_mode():
        try:
            bad_model(left_s, right_s)
        except ValueError as exc:
            refusal = str(exc)
    emit({"phase": "gate_refusal", "maxdisp": md + 2, "raised": refusal})
    if refusal is None or "band kernel refuses" not in refusal:
        raise AssertionError("a refused cost on the card did not raise")
    if read_counts() != counts:
        raise AssertionError("a refused cost launched a kernel")

    # ---- 8. the predict and evaluate drivers on the bundled KITTI frames
    cli = cli_phase(model, counters, card)
    cli_of = {r["head"]: {"cli_run": run, "cli_launches": r["launches"], "cli_frames": r["frames"]}
              for run, r in cli.items() if run not in ("predict", "evaluate --full_frame")}

    # ---- 9. export: the .pt2 driver, the loaded programs' launches and times
    export_launches = export_phase(model, state, counters, card)

    # ---- 10. training: the band kernel at the train shape, a train step's
    # kernel path against its plain path, the KITTI fine-tune through the driver
    train = train_phase(counters, card)
    train_of = {k: {"finetune_launches": n, "finetune_steps": train["train_steps"],
                    "finetune_val_frames": train["val_frames"]} for k, n in train["launches"].items()}
    train_of["band_soft_argmin"].update({"train_ms": train["band_ms"], "train_plain_ms": train["band_plain_ms"],
                                         "train_bound_ms": train["band_bound_ms"],
                                         "train_max_abs_err": train["band_err"]})
    train_of["fused_head_sm90"].update({"train_ms": train["head_ms"], "train_plain_ms": train["head_plain_ms"],
                                        "train_bound_ms": train["head_bound_ms"],
                                        "train_max_abs_err": train["head_err"]})

    # ---- 11. search: the band kernel at the search cost, a supernet step's
    # kernel path against its plain path and remat on against off, the
    # reference search through cli.search, decode, the decoded network
    search = search_phase(counters, card)

    # ---- 12. parallel runs: the disparity-sharded KITTI frame, data-parallel
    # steps and disparity-sharded train steps on two gloo ranks of the card,
    # cli.train over NCCL at world size 1
    par = parallel_phase(counters, card)
    par_of = {k: {"parallel_sharded_frame_launches": [l[k] for l in par["sharded_launches"]],
                  "parallel_sharded_train_launches": [l[k] for l in par["sharded_train_launches"]],
                  "parallel_nccl_launches": par["nccl_launches"][k]} for k in counters}
    par_of["band_soft_argmin"]["parallel_dp_launches_per_rank"] = par["dp_band_launches_per_rank"]

    # ---- kernel table, card, result
    # launches: each kernel's count over the run of the path that uses it,
    # zeroed just before it: the KITTI bf16 default forward (phase 5's four
    # frames, sm90 head), its confidence forward (phase 4, band kernel), the fp32 default
    # forward (phase 6, fp32 sm90 head), the op on volumes TMA cannot read in
    # place (phase 6, the repitch routes); padded_channels_path_launches: the fp32
    # forward with a 24-channel matching net (phase 6); fp32_frame_launches:
    # the four fp32 KITTI frames of phase 5; finetune_launches: over the
    # fine-tune's train steps and val frames (phase 10, zeroed just before);
    # train_*: phase 10's check and times at the fine-tune's shapes (band
    # kernel: the train cost (4, 64, 96, 192); sm90 head: the val volume);
    # export_launches: over the loaded .pt2 programs' frames (phase 9, zeroed
    # just before each); search_launches: over the reference search's weight
    # steps, arch steps and val frames (phase 11, zeroed just before);
    # search_ms, search_plain_ms, search_bound_ms, search_max_abs_err: the
    # band kernel at the search cost (2, 64, 64, 128); search_decode_launches:
    # the decoded network's KITTI frame (phase 11);
    # parallel_sharded_frame_launches: each rank's over the disparity-sharded
    # bf16 KITTI frames (phase 12a, 0: the sharded head is the plain one);
    # parallel_dp_launches_per_rank: over the 3 data-parallel steps (12b);
    # parallel_sharded_train_launches: each rank's over the disparity-sharded
    # Middlebury steps (12d: 3 fp32 and 8 bf16; 0, as in JAX under a pspec);
    # parallel_nccl_launches: over cli.train --multihost's 3 steps and val
    # frames (12c); route_shapes: phase 3's times at the shapes a route takes
    # that the first design alone took before; kitti_forced_ms: a repitch
    # route forced on the KITTI volume the in-place route reads (phase 3).
    # library_ms is null for the heads: no one PyTorch call computes them;
    # yardstick_ms is the unfused pair (cuDNN last_3 + band kernel). The
    # NDHWC kernels: ms, library_ms and bound_ms summed over a KITTI frame's
    # calls (middlebury_*: a Middlebury frame's), library_ms their plain
    # versions' (phase 4's check frames); launches over phase 5's default
    # forward frames.
    def shapes_of(route: str) -> dict:
        return {n: {k: r[k] for k in ("ms", "yardstick_ms", "bound_ms", "max_abs_err")}
                for n, r in routes.items() if r["route"] == route}

    def repitch_entry(name: str, shape: str, path: str) -> dict:
        r = routes[shape]
        return {"name": name, "route": "cuda", "source": SRC_SM90, "replaces": "leastereo_tpu/ops/pallas_head.py:96",
                "launches": op_launches[name], "path": path,
                "max_abs_err": max([errs[name]] + [x["max_abs_err"] for x in shapes_of(r["route"]).values()]),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None, "yardstick_ms": r["yardstick_ms"], "shape": r["shape"],
                "route_shapes": shapes_of(r["route"]),
                "kitti_forced_ms": best["c32_repitch" if "f32" not in name else "c32_f32_repitch"],
                "entry": "torch.ops.leastereo.conv_soft_argmin", "export_launches": export_launches[name],
                "fp32_frame_launches": fp32_frame_launches[name], **cli_of.get(name, {}), **train_of[name],
                **par_of[name]}

    def ndhwc_entry(name: str, path: str) -> dict:
        kitti, md = ndhwc_check["kitti"][name], ndhwc_check["middlebury"][name]
        return {"name": name, "route": "cuda", "source": SRC_NDHWC, "replaces": None,
                "launches": ndhwc_launches[name], "launches_per_frame": ndhwc_launches[name] / default_frames,
                "path": path, "max_abs_err": max(kitti["max_abs_diff"], md["max_abs_diff"]),
                "ms": kitti["ms"], "plain_ms": kitti["library_ms"], "bound_ms": kitti["bound_ms"], "bound_by": "bytes",
                "library_ms": kitti["library_ms"], "middlebury_ms": md["ms"], "middlebury_library_ms": md["library_ms"],
                "middlebury_bound_ms": md["bound_ms"], "calls_per_frame": kitti["calls"]}

    def conv3d_entry() -> dict:
        # A frame's sums over the classes (calls a frame x a call's ms) at
        # KITTI (ms, bound_ms, plain_ms, library_ms: cuDNN's fused call) and
        # Middlebury (middlebury_*); cudnn_benchmark_ms: cuDNN's own pick.
        def frame_sum(frame: str, key: str) -> float:
            return sum(r["calls_per_frame"] * r[key] for r in conv_rows if r["frame"] == frame and r["admitted"])

        entry = {"name": "conv3d_sm90", "route": "cuda", "source": SRC_CONV3D, "replaces": None,
                 "launches": conv3d_launches, "launches_per_frame": conv3d_launches / default_frames,
                 "path": "the eval matching net's 3x3x3 convolutions (phase 5)",
                 "max_abs_err": max(r["max_abs_err"] for r in conv_rows if r["admitted"]), "bound_by": "per class",
                 "classes": [{k: r[k] for k in ("frame", "cin", "cout", "dhw", "calls_per_frame", "admitted")}
                             for r in conv_rows]}
        for prefix, frame in (("", "kitti"), ("middlebury_", "middlebury")):
            for key, col in (("ms", "sm90_ms"), ("bound_ms", "bound_ms"), ("plain_ms", "plain_ms"),
                             ("library_ms", "fused_ms"), ("cudnn_benchmark_ms", "cudnn_benchmark_ms")):
                entry[prefix + key] = frame_sum(frame, col)
        return entry

    emit({"kernels": [
        {"name": "fused_head_sm90", "route": "cuda", "source": SRC_SM90,
         "replaces": "leastereo_tpu/ops/pallas_head.py:96", "launches": default_launches["fused_head_sm90"],
         "launches_per_frame": default_launches["fused_head_sm90"] / default_frames,
         "path": "KITTI bf16 default forward (phase 5)", "max_abs_err": errs["fused_head_sm90"], "ms": sm90_ms,
         "plain_ms": head_plain_ms, "bound_ms": head_bound[0], "bound_by": head_bound[1], "library_ms": None,
         "yardstick_ms": unfused_ms, "route_shapes": shapes_of("sm90"), **cli_of["fused_head_sm90"], **train_of["fused_head_sm90"],
         "entry": "torch.ops.leastereo.conv_soft_argmin", "export_launches": export_launches["fused_head_sm90"],
         "search_decode_launches": search["decode_launches"], **par_of["fused_head_sm90"]},
        {"name": "fused_head_sm90_f32", "route": "cuda", "source": SRC_SM90,
         "replaces": "leastereo_tpu/ops/pallas_head.py:96", "launches": fp32_launches["fused_head_sm90_f32"],
         "launches_per_frame": fp32_launches["fused_head_sm90_f32"] / 1,
         "path": "fp32 default forward (phase 6); every fp32 frame (phase 5, cli, export)",
         "max_abs_err": errs["fused_head_sm90_f32"], "ms": sm90_f32_ms, "plain_ms": head_fp32_plain_ms,
         "bound_ms": head_fp32_bound[0], "bound_by": head_fp32_bound[1], "library_ms": None,
         "yardstick_ms": unfused32_ms, "share_of_bound": head_fp32_bound[0] / sm90_f32_ms,
         "wide_span_300x_err": wide["fused_head_sm90_f32"],
         "padded_channels_path_launches": padded_launches["fused_head_sm90_f32"],
         "padded_channels_path_kernel_vs_plain_px": padded_err,
         **cli_of["fused_head_sm90_f32"], **train_of["fused_head_sm90_f32"],
         "fp32_frame_launches": fp32_frame_launches["fused_head_sm90_f32"], "fp32_frame_frames": 4,
         "fp32_kitti_frame_device_ms": fp32_frame_ms, "fp32_kitti_frame_kernel_ms": fp32_head_frame_ms,
         "entry": "torch.ops.leastereo.conv_soft_argmin", "export_launches": export_launches["fused_head_sm90_f32"],
         **par_of["fused_head_sm90_f32"]},
        repitch_entry("fused_head_sm90_repitch", "w412",
                      "the op on bf16 volumes TMA cannot read in place (phase 6: w = 412, and a base 4 bytes past 16)"),
        repitch_entry("fused_head_sm90_f32_repitch", "w414_f32", "the op on an fp32 volume of w = 414 (phase 6)"),
        {"name": "band_soft_argmin", "route": "cuda", "source": SRC_HEADS,
         "replaces": "leastereo_tpu/ops/pallas_softargmin.py:45", "launches": launches["band_soft_argmin"],
         "launches_per_frame": launches["band_soft_argmin"] / 1, "path": "KITTI bf16 confidence forward (phase 4)",
         "max_abs_err": band_err, "ms": band_ms,
         "plain_ms": band_plain_ms, "bound_ms": band_bound[0], "bound_by": band_bound[1], "library_ms": None,
         **cli_of["band_soft_argmin"], **train_of["band_soft_argmin"],
         "entry": "torch.ops.leastereo.band_soft_argmin", "export_launches": export_launches["band_soft_argmin"],
         "search_launches": search["launches"], "search_ms": search["ms"], "search_plain_ms": search["plain_ms"],
         "search_bound_ms": search["bound_ms"], "search_max_abs_err": search["err"], **par_of["band_soft_argmin"]},
        ndhwc_entry("stem_ndhwc", "the eval matching net's stem, NDHWC (phase 5)"),
        ndhwc_entry("cat_ndhwc", "the eval matching net's cell and skip concatenations (phase 5)"),
        ndhwc_entry("resize_ndhwc", "the eval matching net's 3-D resizes, the last written NCDHW (phase 5)"),
        conv3d_entry(),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # a rank of phase 12, started by the phase itself
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
