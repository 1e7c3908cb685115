#!/usr/bin/env python3
"""Drive the PyTorch port (leastereo_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure (nothing is
caught, so any failure exits non-zero):

1. card: name and power limit (nvidia-smi); TF32 off for the fp32 phases.
2. build: the CUDA kernels built from leastereo_tpu_torch/csrc with nvcc.
3. kernels: each kernel on the card at the KITTI main-path shapes against
   its plain PyTorch version evaluated in float64, on peaky (trained-like),
   wide (the peaky cost scaled 10x, a span of hundreds of units) and
   diffuse inputs: the sm90 fused head (bf16 volume), the first fused head
   design (fp32 and bf16 volumes) and the band kernel; the band kernel and
   the sm90 head on a 300x cost beside the fp32 plain version, both against
   float64 (a measurement: there fp32 rounding of the cost alone moves the
   result by ~3e-3 px); then their times on one bf16 input beside the
   unfused yardstick (cuDNN ``last_3`` conv + band kernel), the band
   kernel's grid and occupancy, and the first design's time at shapes that
   show what limits it.
4. main path: ``best_sceneflow_model`` at KITTI 384x1248, maxdisp 192, bf16,
   eval, random seeded weights: the default forward (sm90 fused head, once
   per frame), timed for >= 10 s, then the ``return_entropy`` forward (band
   kernel). Launch counts are zeroed just before and read just after.
5. layers and profile: per-layer times and the device's busy share.
6. whole model, kernel path against plain path, fp32, 96x192, maxdisp 48
   (the first fused head design and the band kernel; counts zeroed just
   before and read just after).
7. gate refusal: a cost the band kernel refuses raises on the card.
8. cli: the predict and evaluate drivers (``leastereo_tpu_torch.cli``)
   called in-process on the bundled KITTI frames (``dataset/kitti15_part``)
   at 384x1248, maxdisp 192, with phase 4's weights saved as a torch file
   and given as ``--checkpoint``, writing into a temporary directory:
   evaluate on the 4 ``train`` frames by default (sm90 head), with
   ``--confidence`` (band kernel) and with ``--dtype float32`` (the first
   fused head design), then predict on the ``test`` frame. Each run's
   outputs, metrics and launch counts (zeroed just before, read just after:
   one launch of its head per frame, none of the others) are checked, and
   frame 0 of the default run is held against phase 4's model called
   directly. Prints each run's per-frame load, ``run_frame`` and save times.
9. train: the band kernel at the train forward's cost (4, 64, 96, 192),
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
   from ``best`` starting below the cold run's first loss. Prints the step
   and val frame times, the peak memory, and from one profiled step the
   device time by kernel kind and the band kernel's share.

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
    ("head kernels (this port)", ("head_kernel", "head_sm90_kernel", "band_kernel")),
    ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions (cuDNN)", ("xmma", "implicit_gemm", "conv", "cudnn", "gemm", "sm90_", "sm80_")),
    ("trilinear/bilinear resize", ("upsample",)),
    ("gathers (fused stem)", ("index", "gather")),
    ("elementwise (add, relu, cast, cat)", ("elementwise", "CatArray", "reduce")),
)
TOL_KERNEL_PX = 2e-3  # kernels against float64 plain versions
SRC_SM90 = "leastereo_tpu_torch/csrc/fused_head_sm90.cu"
SRC_HEADS = "leastereo_tpu_torch/csrc/soft_argmin_heads.cu"
TOL_MODEL_PX = 2e-3  # whole model, kernel path against plain path, fp32
TOL_CLI_PX = 2e-3  # the evaluate driver's frame 0 against the model called directly
# Phase 9, training. The KITTI fine-tune recipe (run/kitti_ft_r05/README.md:15-19):
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
    ("evaluate --dtype float32", "evaluate", "train", ["--dtype", "float32"], "fused_head"),
    ("predict", "predict", "test", [], "fused_head_sm90"),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def bound(bytes_moved: int, flops: int, flop_dtype, exps: int) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over memory rate against operations
    (conv FLOPs at the peak of their input type, exponentials at the SFU rate)."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = max(flops / PEAK_FLOPS[flop_dtype], exps / PEAK_SFU_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def peaky_cost(gen, b, d, h, w, dev):
    """Trained-like unimodal cost plus noise (as tests/test_pallas_softargmin.py)."""
    best = torch.randint(0, d, (b, 1, h, w), generator=gen, device=dev)
    planes = torch.arange(d, device=dev).view(1, d, 1, 1)
    return 0.35 * (planes - best).abs().float() + 0.8 * torch.randn(b, d, h, w, generator=gen, device=dev)


WIDE = 10.0  # scale of the "wide" inputs' cost (a span of ~250 units at D = 64)
SPAN_300 = 300.0  # scale of the cost in phase wide_span_300x


def head_inputs(gen, kind, b, c, d, h, w, dev):
    """Pre-head volume (B, C, D, h, w) and last_3 kernel (1, C, 3, 3, 3).
    "peaky": channel 0 carries a trained-like cost that the kernel's centre
    tap passes through; "wide": the same with the kernel scaled WIDE times;
    "diffuse": random volume and kernel."""
    vol = 0.5 * torch.randn(b, c, d, h, w, generator=gen, device=dev)
    if kind in ("peaky", "wide"):
        vol[:, 0] = peaky_cost(gen, b, d, h, w, dev)
        kern = 0.02 * torch.randn(1, c, 3, 3, 3, generator=gen, device=dev)
        kern[0, 0, 1, 1, 1] += 1.0
        if kind == "wide":
            kern *= WIDE
    else:
        kern = 0.2 * torch.randn(1, c, 3, 3, 3, generator=gen, device=dev)
    return vol, kern


def _timed(fn, ms: list):
    """``fn``, appending the wall ms of each call to ``ms``."""

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        ms.append(1e3 * (time.perf_counter() - t0))
        return out

    return timed


@contextlib.contextmanager
def stage_times(calls: dict, returned: dict):
    """While the block runs, time every call of each function
    ``calls[label] = (owner, name)`` and of each function that
    ``returned[label] = (owner, name)`` returns (wall ms, a list per label)."""
    times = {label: [] for label in {**calls, **returned}}
    saved = []
    for label, (owner, name) in calls.items():
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, _timed(saved[-1][2], times[label]))
    for label, (owner, name) in returned.items():
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, lambda *a, _fn=saved[-1][2], _ms=times[label], **k: _timed(_fn(*a, **k), _ms))
    try:
        yield times
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def cli_phase(model, counters: dict, card: str) -> dict:
    """Phase 8: the drivers' ``main(argv)`` on the bundled KITTI frames with
    ``model``'s weights as ``--checkpoint``. Returns each run's launches."""
    from leastereo_tpu_torch.cli import evaluate, predict
    from leastereo_tpu_torch.data import ListSet, StereoListDataset

    H, W = CLI_H, CLI_W
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
            # run_frame: pad, forward, un-pad; forward: H2D, the model, D2H.
            stages = {"load": (StereoListDataset, "load_stack"), "run_frame": (mod, "run_frame"),
                      "save": (mod, "save_frame")}
            with stage_times(stages, {"forward": (mod, "make_forward")}) as ms, contextlib.redirect_stdout(printed):
                rc = mod.main(argv)
            launches = {k: fn.launches for k, fn in counters.items()}
            frames = len(ms["run_frame"])
            if rc != 0 or frames != len(names):
                raise AssertionError(f"cli {run}: rc {rc}, {frames} frames of {len(names)}")
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
                    **{f"{k}_ms_median": float(np.median(v)) for k, v in ms.items()},
                    **{f"{k}_ms": v for k, v in ms.items()},
                    "launches": launches, "metrics_mean": means, "cudnn_tf32": True,
                    "note": "random seeded weights (phase 4's): the metrics show only that the pipeline runs"}
            if run == "evaluate":
                # Frame 0 against phase 4's model on the same padded input,
                # un-padded the same way (after the counts were read).
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
            emit(line)
            result[run] = {"head": head, "launches": launches[head], "frames": frames}
    return result


def train_phase(counters: dict, card: str) -> dict:
    """Phase 9: training. The band kernel at the train forward's cost shape
    (forward and gradient), the sm90 head at the val frame's volume, one
    train step of the kernel path against the plain path, then
    ``cli.train.main`` on the KITTI fine-tune recipe. Returns the
    fine-tune's launches of each head and both heads' checks and times at
    the fine-tune's shapes."""
    import leastereo_tpu_torch.models.leastereo as lst
    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
    from leastereo_tpu_torch.cli import evaluate
    from leastereo_tpu_torch.cli import train as train_cli
    from leastereo_tpu_torch.data import ListSet, StereoListDataset, make_loader
    from leastereo_tpu_torch.ops.fused_head import conv_soft_argmin_reference, conv_soft_argmin_sm90
    from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda, soft_argmin_fused
    from leastereo_tpu_torch.ops.softargmin import soft_argmin
    from leastereo_tpu_torch.train import make_optimizer, masked_smooth_l1, train_step

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(6)
    b, d, h, w, maxdisp = TRAIN_B, 64, TRAIN_H // 3, TRAIN_W // 3, 192

    # 9a. The band kernel at the train forward's cost, forward against the
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

    # 9a'. The sm90 head at every val frame's pre-head volume (eval at
    # 288x576: (1, 32, 64, 96, 192) bf16) against its plain version in float64.
    c = 32
    head = {"card": card, "shape": [1, c, d, h, w], "dtype": "torch.bfloat16", "tol_px": TOL_KERNEL_PX}
    for kind in ("peaky", "wide", "diffuse"):
        vol, kern = head_inputs(gen, kind, 1, c, d, h, w, dev)
        vol = vol.to(torch.bfloat16)
        ref = conv_soft_argmin_reference(vol.double(), kern.double(), maxdisp)
        head[f"{kind}_max_abs_err_px"] = (conv_soft_argmin_sm90(vol, kern, maxdisp).double() - ref).abs().max().item()
        del ref
        if not head[f"{kind}_max_abs_err_px"] < TOL_KERNEL_PX:
            emit({"phase": "train_val_head", **head})
            raise AssertionError(f"sm90 head at the val frame's volume, {kind}: {head}")
    head["ms"] = cuda_ms(lambda: conv_soft_argmin_sm90(vol, kern, maxdisp))
    head["plain_ms"] = cuda_ms(lambda: conv_soft_argmin_reference(vol, kern, maxdisp), iters=5)
    head["bound_ms"], head["bound_by"] = bound(vol.numel() * 2 + kern.numel() * 4 + 9 * h * w * 4,
                                               2 * 27 * c * d * h * w, torch.bfloat16, 9 * h * w * d)
    emit({"phase": "train_val_head", **head})
    del vol, kern
    torch.cuda.empty_cache()

    # 9b. One train step (forward, masked loss, backward), kernel path against
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

    # 9c. The fine-tune through the driver, with the plain head barred from
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
        torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        saved_plain, lst.soft_argmin = lst.soft_argmin, no_plain_head
        t0 = time.perf_counter()
        try:
            with stage_times({"train_step": (train_cli, "train_step"), "eval_step": (train_cli, "eval_step")},
                             {}) as ms, contextlib.redirect_stdout(printed):
                rc = train_cli.main(recipe + ["--epochs", str(TRAIN_EPOCHS), "--run_root", tmp, "--experiment", "ft"])
        finally:
            lst.soft_argmin = saved_plain
        run_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        exp = os.path.join(tmp, "kitti15_part-train", "ft")
        log = read_log(exp)
        train_log = [ln for ln in log if "loss" in ln]
        val_log = [ln for ln in log if "val_err3" in ln]
        n_steps, n_val = len(ms["train_step"]), len(ms["eval_step"])
        ckpts = {kind: sorted(os.listdir(os.path.join(exp, "checkpoints", kind)))
                 for kind in os.listdir(os.path.join(exp, "checkpoints"))}
        line = {"phase": "train", "card": card, "recipe": recipe + ["--epochs", str(TRAIN_EPOCHS)], "rc": rc,
                "seconds": run_s, "steps": n_steps, "val_frames": n_val, "launches": launches,
                "train_step_ms_median_2_to_last": float(np.median(ms["train_step"][1:])),
                "train_step_ms": ms["train_step"], "val_frame_ms_median": float(np.median(ms["eval_step"])),
                "peak_mem_gb": peak_gb, "explicit_volume_gb": TRAIN_B * 64 * (maxdisp // 3) * h * w * 2 / 1e9,
                "logged": [{k: ln[k] for k in ("step", "loss", "epe", "err3")} for ln in train_log],
                "val_err3": [ln["val_err3"] for ln in val_log], "checkpoints": ckpts}
        losses = [ln["loss"] for ln in train_log]
        ok = (rc == 0 and n_steps == TRAIN_EPOCHS and n_val == TRAIN_EPOCHS and len(val_log) == TRAIN_EPOCHS
              and all(math.isfinite(x) for x in losses) and train_log[-1]["step"] == TRAIN_EPOCHS
              and losses[-1] < 0.5 * losses[0]
              and launches == {k: {"band_soft_argmin": n_steps, "fused_head_sm90": n_val}.get(k, 0) for k in counters}
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

        # One more step of the recipe's shapes, alone: its peak memory, and
        # under the profiler the device time by kernel and the band kernel's share.
        ds = StereoListDataset("kitti15_part", ListSet.resolve("kitti15_part", lists_dir).train, root=KITTI_ROOT,
                               crop_size=(TRAIN_H, TRAIN_W), training=True, seed=2019)
        batch = next(iter(make_loader(ds, TRAIN_B, device=dev, seed=2019, num_workers=2)(0)))
        model = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="bfloat16"), seed=2019)
        opt = make_optimizer([p for p in model.parameters()], "adam", 1e-3)
        train_step(model, opt, batch, maxdisp, 1e-3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        train_step(model, opt, batch, maxdisp, 1e-3)
        step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_step(model, opt, batch, maxdisp, 1e-3)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    band_ms = sum(e.self_device_time_total for e in events if "band_kernel" in e.key) / 1e3
    groups = {}
    for e in events:
        kind = next((k for k, pats in KERNEL_GROUPS if any(p in e.key for p in pats)), "other")
        groups[kind] = groups.get(kind, 0.0) + e.self_device_time_total / 1e3
    line.update({"step_alone_peak_mem_gb": step_peak_gb, "step_alone_start_mem_gb": base_gb,
                 "profiled_step_device_ms": busy_ms, "band_kernel_device_ms": band_ms,
                 "band_kernel_share": band_ms / busy_ms,
                 "profiled_step_device_ms_by_kind": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                 "top_kernels_ms": [[e.key[:100], e.self_device_time_total / 1e3]
                                    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]]})
    if not band_ms > 0:
        raise AssertionError("the profiled train step shows no band kernel time")
    emit(line)
    del model, opt, batch
    torch.cuda.empty_cache()
    return {"train_steps": n_steps, "val_frames": n_val, "launches": launches,
            "band_ms": band["ms"], "band_plain_ms": band["plain_ms"], "band_bound_ms": band["bound_ms"],
            "band_bound_by": band["bound_by"], "band_err": max(band["peaky_max_abs_err_px"], band["diffuse_max_abs_err_px"]),
            "head_ms": head["ms"], "head_plain_ms": head["plain_ms"], "head_bound_ms": head["bound_ms"],
            "head_err": max(head[f"{kind}_max_abs_err_px"] for kind in ("peaky", "wide", "diffuse"))}


def calibrate_head(model, left, right) -> None:
    """Scale the matching ``last_3`` kernel so the cost spans a few units.
    Random weights give a cost of huge magnitude, where softmin degenerates
    to a hard argmin and the soft-argmin is ill conditioned."""
    cfg = model.config
    with torch.no_grad():
        x = torch.cat([left, right]).permute(0, 3, 1, 2).to(cfg.dtype)
        feats = model.feature(x)
        pre = model.matching(feats[: left.shape[0]], feats[left.shape[0] :], cfg.maxdisp // 3)
        std = model.matching.last_3(pre).float().std()
        model.matching.last_3.conv.weight.mul_(3.0 / std)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card only", file=sys.stderr)
        return 2

    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
    from leastereo_tpu_torch.ops import _build
    from leastereo_tpu_torch.ops.fused_head import (
        conv_soft_argmin_cuda,
        conv_soft_argmin_reference,
        conv_soft_argmin_simt,
        conv_soft_argmin_sm90,
    )
    from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda
    from leastereo_tpu_torch.ops.softargmin import soft_argmin

    dev = torch.device("cuda")
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
    emit({"phase": "build", "seconds": build_s, "built": ["fused_head_sm90", "fused_head", "band_soft_argmin"],
          "sources": [SRC_SM90, SRC_HEADS], "ptxas": ptxas})

    # ---- 3. kernels against their plain versions at the main path's shapes
    b, c, d, h, w, maxdisp = 1, 32, 64, 128, 416, 192
    gen = torch.Generator(device=dev).manual_seed(0)
    head_err, sm90_err, band_err = 0.0, 0.0, 0.0
    for kind in ("peaky", "wide", "diffuse"):
        vol32, kern = head_inputs(gen, kind, b, c, d, h, w, dev)
        for name, fn, dt in (("fused_head_sm90", conv_soft_argmin_sm90, torch.bfloat16),
                             ("fused_head", conv_soft_argmin_simt, torch.float32),
                             ("fused_head", conv_soft_argmin_simt, torch.bfloat16)):
            vol = vol32.to(dt)
            got = fn(vol, kern, maxdisp)
            ref = conv_soft_argmin_reference(vol.double(), kern.double(), maxdisp)
            err = (got.double() - ref).abs().max().item()
            emit({"phase": "kernel_check", "kernel": name, "input": kind, "dtype": str(dt),
                  "shape": list(vol.shape), "max_abs_err_px": err, "tol_px": TOL_KERNEL_PX})
            if not err < TOL_KERNEL_PX:
                raise AssertionError(f"{name} {kind} {dt}: {err} px")
            if name == "fused_head_sm90":
                sm90_err = max(sm90_err, err)
            else:
                head_err = max(head_err, err)
            del ref
        if kind == "diffuse":
            cost = torch.randn(b, d, h, w, generator=gen, device=dev)
        else:
            cost = peaky_cost(gen, b, d, h, w, dev) * (WIDE if kind == "wide" else 1.0)
        got = soft_argmin_cuda(cost, maxdisp)
        err = (got.double() - soft_argmin(cost.double(), maxdisp)).abs().max().item()
        emit({"phase": "kernel_check", "kernel": "band_soft_argmin", "input": kind, "dtype": "torch.float32",
              "shape": list(cost.shape), "max_abs_err_px": err, "tol_px": TOL_KERNEL_PX})
        if not err < TOL_KERNEL_PX:
            raise AssertionError(f"band kernel {kind}: {err} px")
        band_err = max(band_err, err)

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
    wide["fused_head_plain_fp32"] = (conv_soft_argmin_reference(v300.float(), k300, maxdisp).double() - ref).abs().max().item()
    c300 = SPAN_300 * peaky_cost(gen, b, d, h, w, dev)
    ref = soft_argmin(c300.double(), maxdisp)
    wide["band_soft_argmin"] = (soft_argmin_cuda(c300, maxdisp).double() - ref).abs().max().item()
    wide["band_plain_fp32"] = (soft_argmin(c300, maxdisp).double() - ref).abs().max().item()
    emit({"phase": "wide_span_300x", "max_abs_err_px": wide})
    del v300, c300, ref

    vol = vol32.to(torch.bfloat16)  # main path: bf16 volume
    kern16 = kern.to(torch.bfloat16)
    # Both fused heads and the unfused yardstick (cuDNN last_3 conv, then the
    # band kernel; the port does not run this pair on this route) in turns.
    unfused = lambda: soft_argmin_cuda(torch.nn.functional.conv3d(vol, kern16, padding=1)[:, 0].float(), maxdisp)
    sm90_ms = [cuda_ms(lambda: conv_soft_argmin_sm90(vol, kern, maxdisp))]
    head_ms = [cuda_ms(lambda: conv_soft_argmin_simt(vol, kern, maxdisp))]
    unfused_ms = [cuda_ms(unfused)]
    head_ms.append(cuda_ms(lambda: conv_soft_argmin_simt(vol, kern, maxdisp)))
    sm90_ms.append(cuda_ms(lambda: conv_soft_argmin_sm90(vol, kern, maxdisp)))
    unfused_ms.append(cuda_ms(unfused))
    sm90_bf16w_ms = cuda_ms(lambda: conv_soft_argmin_sm90(vol, kern16, maxdisp))
    sm90_ms, head_ms, unfused_ms = min(sm90_ms), min(head_ms), min(unfused_ms)
    head_plain_ms = cuda_ms(lambda: conv_soft_argmin_reference(vol, kern, maxdisp), iters=5)
    band_ms = cuda_ms(lambda: soft_argmin_cuda(cost, maxdisp))
    band_plain_ms = cuda_ms(lambda: soft_argmin(cost, maxdisp), iters=5)
    out_bytes = b * 9 * h * w * 4
    exps = b * 9 * h * w * d  # one per low-res plane and output phase
    head_flops = 2 * 27 * c * b * d * h * w
    head_bound = bound(vol.numel() * 2 + kern.numel() * 4 + out_bytes, head_flops, torch.bfloat16, exps)
    band_bound = bound(cost.numel() * 4 + out_bytes, 0, torch.float32, exps)
    emit({"phase": "kernel_times", "card": card, "fused_head_sm90_ms": sm90_ms,
          "fused_head_sm90_bf16_weights_ms": sm90_bf16w_ms, "fused_head_pr1_ms": head_ms,
          "unfused_ms": unfused_ms, "fused_head_plain_ms": head_plain_ms, "fused_head_bound_ms": head_bound[0],
          "band_ms": band_ms, "band_plain_ms": band_plain_ms, "band_bound_ms": band_bound[0],
          "band_bound_by": band_bound[1], "exponentials": exps,
          "note": "ms: best of two turns (sm90, first design, unfused, first design, sm90, unfused); "
                  "fused heads take the fp32 kernel, the unfused cuDNN conv its bf16 rounding"})

    # The band kernel's grid at KITTI against the card's resident-block slots.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    band_blocks = b * -(-h // _build.BAND_TILE_H) * -(-w // _build.BAND_TILE_W)
    band_per_sm = _build.load_kernels().lst_band_blocks_per_sm(d)
    emit({"phase": "band_grid", "card": card, "tile": [_build.BAND_TILE_H, _build.BAND_TILE_W],
          "blocks": band_blocks, "blocks_per_sm": band_per_sm, "slots": band_per_sm * sms,
          "waves": band_blocks / (band_per_sm * sms), "smem_bytes": _build.band_smem_bytes(d)})
    if band_per_sm < 1:
        raise AssertionError(f"band kernel occupancy query failed: {band_per_sm}")

    # What limits the first design (head_kernel<bf16>, 8 x 32 tiles, one
    # 512-thread block per SM by shared memory and registers): its time at
    # half the rows (104 blocks, one wave on 132 SMs, against 208 in two),
    # at half the channels, and on an fp32 volume, plus the rates its KITTI
    # time implies. Shared-memory traffic counts its code's accesses: per
    # block and channel, D * (TH+4)(TW+4) staged stores and, per work item
    # ((TH+2)(TW+2) sites x ceil(D/8)), 90 slab loads and 8 tile updates.
    v_h64 = vol[:, :, :, : h // 2].contiguous()
    v_c16, k_c16 = vol[:, : c // 2].contiguous(), kern[:, : c // 2].contiguous()
    v_f32 = vol.float()
    th, tw, dch = _build.TILE_H, _build.TILE_W, _build.DCHUNK
    blocks = b * -(-h // th) * -(-w // tw)
    items = (th + 2) * (tw + 2) * -(-d // dch)
    smem_bytes = 4 * blocks * c * (d * (th + 4) * (tw + 4) + items * (90 + 2 * dch))
    emit({"phase": "head_profile", "card": card, "kernel": "head_kernel<bf16> (first design)",
          "ms_kitti": head_ms, "ms_half_rows_one_wave": cuda_ms(lambda: conv_soft_argmin_simt(v_h64, kern, maxdisp)),
          "ms_half_channels": cuda_ms(lambda: conv_soft_argmin_simt(v_c16, k_c16, maxdisp)),
          "ms_fp32_volume": cuda_ms(lambda: conv_soft_argmin_simt(v_f32, kern, maxdisp)),
          "blocks": blocks, "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "dram_gb_s": (vol.numel() * 2 + out_bytes) / head_ms / 1e6,
          "smem_tb_s": smem_bytes / head_ms / 1e9,
          "fma_tflop_s": 2 * 27 * blocks * c * items * dch / head_ms / 1e9,
          "sm90_dram_gb_s": (vol.numel() * 2 + out_bytes) / sm90_ms / 1e6,
          # The sm90 kernel (8 x 16 tiles, two blocks per SM): 27 x 16 = 432
          # blocks at KITTI, 1.64 waves of 264 slots; half the rows, one wave.
          "sm90_ms_half_rows": cuda_ms(lambda: conv_soft_argmin_sm90(v_h64, kern, maxdisp))})
    del vol32, vol, cost, v_h64, v_c16, v_f32
    torch.cuda.empty_cache()

    # ---- 4. main path at KITTI
    H, W = 384, 1248
    rng = np.random.RandomState(0)
    left = torch.from_numpy(rng.randn(1, H, W, 3).astype(np.float32)).to(dev)
    right = torch.from_numpy(rng.randn(1, H, W, 3).astype(np.float32)).to(dev)
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="bfloat16"), seed=0)
    calibrate_head(model, left, right)
    model_conf = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="bfloat16", return_entropy=True))
    model_conf.load_state_dict(model.state_dict())
    conv_soft_argmin_simt.launches = conv_soft_argmin_sm90.launches = soft_argmin_cuda.launches = 0
    warmup = 3
    with torch.inference_mode():
        for _ in range(warmup):  # warm-up: cuDNN algorithm selection, allocator
            disp = model(left, right)
        torch.cuda.synchronize()
        witness = torch.zeros((), device=dev)
        frames, t0 = 0, time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        while True:
            disp = model(left, right)
            witness += disp.sum()  # full-reduction witness: every pixel feeds it
            frames += 1
            if frames % 10 == 0:
                torch.cuda.synchronize()
                if time.perf_counter() - t0 >= 10.0:
                    break
        elapsed = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        default_launches = {"fused_head_sm90": conv_soft_argmin_sm90.launches, "fused_head": conv_soft_argmin_simt.launches}
        disp_conf, ent = model_conf(left, right)
        torch.cuda.synchronize()
    launches = {"fused_head_sm90": conv_soft_argmin_sm90.launches, "fused_head": conv_soft_argmin_simt.launches,
                "band_soft_argmin": soft_argmin_cuda.launches}
    default_frames = warmup + frames
    d_np = disp.float().cpu().numpy()
    ok = (
        d_np.shape == (1, H, W) and np.isfinite(d_np).all() and d_np.min() >= 0 and d_np.max() <= maxdisp
        and tuple(ent.shape) == (1, H, W) and bool(torch.isfinite(ent).all()) and math.isfinite(witness.item())
        and default_launches == {"fused_head_sm90": default_frames, "fused_head": 0}
        and launches["band_soft_argmin"] == 1
    )
    emit({"phase": "main_path", "card": card, "shape": [1, H, W], "maxdisp": maxdisp, "dtype": "bfloat16",
          "frames": frames, "seconds": elapsed, "frames_per_s": frames / elapsed, "ms_per_frame": 1e3 * elapsed / frames,
          "peak_mem_gb": peak_gb, "disp_min": float(d_np.min()), "disp_max": float(d_np.max()), "disp_std": float(d_np.std()),
          "default_forward_frames": default_frames, "default_forward_launches": default_launches,
          "launches": launches,
          "confidence_disp_vs_default_max_px": (disp_conf.float() - disp.float()).abs().max().item()})
    if not ok:
        raise AssertionError("main path output or launch counts wrong")

    # ---- 5. layers and device busy share
    with torch.inference_mode():
        x = torch.cat([left, right]).permute(0, 3, 1, 2).to(torch.bfloat16)
        feats = model.feature(x)
        fl, fr = feats[:1], feats[1:]
        pre = model.matching(fl, fr, d)
        k3 = model.matching.last_3.conv.weight.to(torch.bfloat16)
        layers = {
            "feature_both_views_ms": cuda_ms(lambda: model.feature(x), iters=5),
            "fused_stem0_ms": cuda_ms(lambda: model.matching.stem0(fl, fr, d), iters=5),
            "matching_net_ms": cuda_ms(lambda: model.matching(fl, fr, d), iters=5),
            "fused_head_ms": cuda_ms(lambda: conv_soft_argmin_cuda(pre, k3, maxdisp), iters=5),
            "fused_head_pr1_ms": cuda_ms(lambda: conv_soft_argmin_simt(pre, k3, maxdisp), iters=5),
            "last_3_conv_plus_band_ms": cuda_ms(
                lambda: soft_argmin_cuda(model.matching.last_3(pre)[:, 0].float(), maxdisp), iters=5),
        }
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(left, right)
            torch.cuda.synchronize()
    # Device-side events only (kernels, copies): operator events carry their
    # kernels' time as well and would count it twice. The idle share compares
    # the device time per frame with the untraced frame time of phase 4, since
    # tracing slows the host.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / 3
    groups = {}
    for e in events:
        name = e.key
        kind = next((k for k, pats in KERNEL_GROUPS if any(p in name for p in pats)), "other")
        groups[kind] = groups.get(kind, 0.0) + e.self_device_time_total / 1e3 / 3
    emit({"phase": "layers", "card": card, **layers,
          "device_ms_per_frame": busy_ms, "device_idle_share": 1 - busy_ms / (1e3 * elapsed / frames),
          "device_ms_per_frame_by_kind": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
          "top_kernels_ms_per_frame": [[e.key[:100], e.self_device_time_total / 1e3 / 3]
                                       for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]]})
    del model_conf, feats, pre, x  # phase 8 reuses the model
    torch.cuda.empty_cache()

    # ---- 6. whole model, kernel path vs plain path, fp32, reduced size
    hs, ws, md = 96, 192, 48
    left_s = torch.from_numpy(rng.randn(1, hs, ws, 3).astype(np.float32)).to(dev)
    right_s = torch.from_numpy(rng.randn(1, hs, ws, 3).astype(np.float32)).to(dev)
    results = {}
    conv_soft_argmin_simt.launches = conv_soft_argmin_sm90.launches = soft_argmin_cuda.launches = 0
    kern_model = best_sceneflow_model(LEAStereoConfig(maxdisp=md, compute_dtype="float32"), seed=1)
    calibrate_head(kern_model, left_s, right_s)
    state = kern_model.state_dict()
    for entropy in (False, True):
        k_model = best_sceneflow_model(LEAStereoConfig(maxdisp=md, compute_dtype="float32", return_entropy=entropy))
        p_model = best_sceneflow_model(
            LEAStereoConfig(maxdisp=md, compute_dtype="float32", return_entropy=entropy, pallas_head=False))
        k_model.load_state_dict(state)
        p_model.load_state_dict(state)
        n_head, n_band = conv_soft_argmin_simt.launches, soft_argmin_cuda.launches
        with torch.inference_mode():
            got, ref = k_model(left_s, right_s), p_model(left_s, right_s)
        if entropy:
            got, ref = got[0], ref[0]
        used = "band_soft_argmin" if soft_argmin_cuda.launches > n_band else (
            "fused_head" if conv_soft_argmin_simt.launches > n_head else None)
        results["return_entropy" if entropy else "default"] = {
            "kernel": used, "max_abs_diff_px": (got - ref).abs().max().item(), "disp_std": ref.std().item()}
    fp32_launches = {"fused_head": conv_soft_argmin_simt.launches, "fused_head_sm90": conv_soft_argmin_sm90.launches}
    emit({"phase": "model_kernel_vs_plain", "shape": [1, hs, ws], "maxdisp": md, "dtype": "float32",
          "tol_px": TOL_MODEL_PX, "launches": fp32_launches, **results})
    if fp32_launches != {"fused_head": 1, "fused_head_sm90": 0}:
        raise AssertionError(f"fp32 default forward launched {fp32_launches}")
    for name, r in results.items():
        if r["kernel"] is None or not r["max_abs_diff_px"] < TOL_MODEL_PX:
            raise AssertionError(f"whole model {name}: {r}")

    # ---- 7. a cost the kernels refuse raises on the card: maxdisp 50 gives
    # D = 16 != 50 / 3, so the fused head falls to the band kernel, whose
    # wrapper raises rather than run the plain version.
    bad_model = best_sceneflow_model(LEAStereoConfig(maxdisp=md + 2, compute_dtype="float32"))
    counts = (conv_soft_argmin_simt.launches, conv_soft_argmin_sm90.launches, soft_argmin_cuda.launches)
    refusal = None
    with torch.inference_mode():
        try:
            bad_model(left_s, right_s)
        except ValueError as exc:
            refusal = str(exc)
    emit({"phase": "gate_refusal", "maxdisp": md + 2, "raised": refusal})
    if refusal is None or "band kernel refuses" not in refusal:
        raise AssertionError("a refused cost on the card did not raise")
    if (conv_soft_argmin_simt.launches, conv_soft_argmin_sm90.launches, soft_argmin_cuda.launches) != counts:
        raise AssertionError("a refused cost launched a kernel")

    # ---- 8. the predict and evaluate drivers on the bundled KITTI frames
    counters = {"fused_head_sm90": conv_soft_argmin_sm90, "fused_head": conv_soft_argmin_simt,
                "band_soft_argmin": soft_argmin_cuda}
    cli = cli_phase(model, counters, card)
    cli_of = {r["head"]: {"cli_run": run, "cli_launches": r["launches"], "cli_frames": r["frames"]}
              for run, r in cli.items() if run != "predict"}

    # ---- 9. training: the band kernel at the train shape, a train step's
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

    # ---- kernel table, card, result
    # launches: each kernel's count over the run of the path that uses it,
    # zeroed just before it: the KITTI bf16 default forward (phase 4, sm90
    # head), its confidence forward (phase 4, band kernel), the fp32 default
    # forward (phase 6, first fused head design); finetune_launches: over the
    # fine-tune's train steps and val frames (phase 9, zeroed just before);
    # train_*: phase 9's check and times at the fine-tune's shapes (band
    # kernel: the train cost (4, 64, 96, 192); sm90 head: the val volume).
    emit({"kernels": [
        {"name": "fused_head_sm90", "route": "cuda", "source": SRC_SM90,
         "replaces": "leastereo_tpu/ops/pallas_head.py:96", "launches": default_launches["fused_head_sm90"],
         "launches_per_frame": default_launches["fused_head_sm90"] / default_frames,
         "path": "KITTI bf16 default forward (phase 4)", "max_abs_err": sm90_err, "ms": sm90_ms,
         "plain_ms": head_plain_ms, "bound_ms": head_bound[0], "bound_by": head_bound[1], "library_ms": None,
         **cli_of["fused_head_sm90"], **train_of["fused_head_sm90"]},
        {"name": "fused_head", "route": "cuda", "source": SRC_HEADS, "replaces": "leastereo_tpu/ops/pallas_head.py:96",
         "launches": fp32_launches["fused_head"], "launches_per_frame": fp32_launches["fused_head"] / 1,
         "path": "fp32 default forward (phase 6); fp32 volumes and bf16 shapes the sm90 gate refuses",
         "max_abs_err": head_err, "ms": head_ms, "plain_ms": head_plain_ms,
         "bound_ms": head_bound[0], "bound_by": head_bound[1], "library_ms": None, **cli_of["fused_head"],
         **train_of["fused_head"]},
        {"name": "band_soft_argmin", "route": "cuda", "source": SRC_HEADS,
         "replaces": "leastereo_tpu/ops/pallas_softargmin.py:45", "launches": launches["band_soft_argmin"],
         "launches_per_frame": launches["band_soft_argmin"] / 1, "path": "KITTI bf16 confidence forward (phase 4)",
         "max_abs_err": band_err, "ms": band_ms,
         "plain_ms": band_plain_ms, "bound_ms": band_bound[0], "bound_by": band_bound[1], "library_ms": None,
         **cli_of["band_soft_argmin"], **train_of["band_soft_argmin"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
