"""Inputs the benchmark makes from ``--seed`` and hands to both the program
and the reference: weights and textured stereo pairs, drawn on the device in
a few large calls."""

from __future__ import annotations

import math
import time

import torch
import torch.nn.functional as F

from .reference.model import Reference, build_reference, cost_volume, exact_float32

__all__ = ["Phases", "torch_seed", "make_state", "make_pairs", "standardize", "to_uint8"]


class Phases:
    """Host seconds of the named stages of a set-up, each from the end of
    the one before (the card synchronised first). The stages in ``OUTSIDE``
    are the reference's work on the inputs, which no request needs: they
    are not counted in ``setup_s``."""

    OUTSIDE = ("bn_calibration",)

    def __init__(self, device):
        self.device, self.seconds, self._t = torch.device(device), {}, time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now

    def outside(self) -> float:
        """Seconds of the stages left out of ``setup_s``."""
        return sum(self.seconds.get(name, 0.0) for name in self.OUTSIDE)


def torch_seed(seed: int, stream: int = 0) -> int:
    """A 63-bit generator seed from any whole ``--seed`` and a stream index,
    so that each kind of input draws from its own sequence."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (2**63)


def make_state(cfg: dict, seed: int, device, phases: Phases | None = None) -> dict:
    """Weights and BN statistics for configuration ``cfg``, keyed as the
    port's ``state_dict``. Convolutions are Kaiming-normal (fan out, as the
    published init); BN scales, shifts and running statistics are jittered
    about the identity; the matching net's ``last_3`` takes
    ``cfg["init"]["last_3_std"]`` so that the cost spans a few units. One
    normal draw of every value on the device. Then the running statistics
    are set to those of one train-mode pass of the reference over a seeded
    pair of ``cfg["init"]["calibration_frame"]``, so that eval activations
    keep their scale through the nets as a trained network's do (with
    statistics of 1 and 0 they grow by orders of magnitude with depth).
    ``phases`` marks ``weights`` after the draw and ``bn_calibration``
    after that pass."""
    with torch.device("meta"):
        names = Reference(cfg).state_dict()
    floats = {k: v for k, v in names.items() if v.is_floating_point()}
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    flat = torch.randn(sum(v.numel() for v in floats.values()), generator=gen, device=device)
    init = cfg["init"]
    state, offset = {}, 0
    for name, like in names.items():
        if not like.is_floating_point():
            state[name] = torch.zeros(like.shape, dtype=like.dtype, device=device)
            continue
        z = flat[offset : offset + like.numel()].view(like.shape)
        offset += like.numel()
        leaf = name.rsplit(".", 1)[-1]
        if name == "matching.last_3.conv.weight":
            state[name] = init["last_3_std"] * z
        elif leaf == "weight" and like.ndim > 1:
            fan_out = like.shape[0] * math.prod(like.shape[2:])
            state[name] = math.sqrt(2.0 / fan_out) * z
        elif leaf == "weight":
            state[name] = 1.0 + init["bn_jitter"] * z
        elif leaf == "running_var":
            state[name] = torch.exp(init["bn_jitter"] * z)
        else:  # bias, running_mean
            state[name] = init["bn_jitter"] * z
    if phases is not None:
        phases.mark("weights")
    _calibrate_bn(cfg, state, seed, device)
    if phases is not None:
        phases.mark("bn_calibration")
    return state


def _calibrate_bn(cfg: dict, state: dict, seed: int, device) -> None:
    ref = build_reference(cfg, state, device, train=True)
    for m in ref.modules():
        if hasattr(m, "momentum"):
            m.momentum = 1.0
    h, w = cfg["init"]["calibration_frame"]
    left, right, _ = make_pairs(1, h, w, cfg["maxdisp"], seed, 3, device)
    with torch.no_grad(), exact_float32():  # both views in one batch, so that one view's statistics do not skew the other's
        feats = ref.feature(torch.cat([standardize(left), standardize(right)]).permute(0, 3, 1, 2))
        ref.matching(cost_volume(feats[:1], feats[1:], cfg["maxdisp"] // 3))
    for name, v in ref.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            state[name] = v


def _octaves(gen, n: int, c: int, h: int, w: int, device) -> torch.Tensor:
    """Smooth noise of several scales, from 1/64 of the frame to single pixels."""
    out = torch.zeros(n, c, h, w, device=device)
    for div, amp in ((64, 1.0), (16, 0.7), (4, 0.5), (1, 0.35)):
        low = torch.randn(n, c, -(-h // div) + 1, -(-w // div) + 1, generator=gen, device=device)
        out += amp * F.interpolate(low, size=(h, w), mode="bilinear", align_corners=True)
    return out


def make_pairs(n: int, h: int, w: int, maxdisp: int, seed: int, stream: int, device):
    """``n`` textured pairs ``(n, 3, h, w)`` and their left disparity
    ``(n, h, w)``: a seeded smooth field in ``[0.05, 0.7) * maxdisp``. The
    right view is textured noise; the left view samples it ``d`` columns
    to the left, so ``d`` is the left view's ground truth; a pixel whose
    match falls outside the frame is invalid (0), as KITTI's occlusions."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, stream))
    right = _octaves(gen, n, 3, h, w, device)
    field = F.interpolate(torch.randn(n, 1, 5, 9, generator=gen, device=device), size=(h, w),
                          mode="bicubic", align_corners=True)[:, 0]
    disp = maxdisp * (0.05 + 0.65 * torch.sigmoid(1.5 * field))
    xs = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w) - disp
    ys = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1).expand(n, h, w)
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], dim=-1)
    left = F.grid_sample(right, grid, mode="bilinear", padding_mode="border", align_corners=True)
    disp = torch.where(xs >= 0, disp, torch.zeros_like(disp))
    return left, right, disp


def standardize(x: torch.Tensor) -> torch.Tensor:
    """Each image's channels to mean 0, std 1 (the loaders' standardisation),
    as NHWC float32."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    std = x.std(dim=(2, 3), keepdim=True, correction=0)
    return ((x - mean) / std).permute(0, 2, 3, 1).contiguous()


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Textured noise as 8-bit RGB, NHWC."""
    return (128.0 + 48.0 * x).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
