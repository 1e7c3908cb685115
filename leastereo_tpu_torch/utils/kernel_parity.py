"""Numerical parity of the port's hand-written CUDA heads on the card (the
counterpart of the JAX package's ``scripts/kernel_parity.py``, which checks
the compiled Pallas kernels on the TPU).

    python -m leastereo_tpu_torch.utils.kernel_parity --out KERNEL_PARITY.json

A unit test of a CUDA kernel can only run on the card, and the CPU tests
reach the kernels' plain versions alone; this module holds each compiled
kernel to its plain version evaluated in float64, at the KITTI main-path
shapes (a ``(1, 32, 64, 128, 416)`` pre-head volume, a ``(1, 64, 128, 416)``
cost, maxdisp 192), on three kinds of input (:func:`head_inputs`), within
``ATOL_PX`` (2e-3 px, the JAX package's own kernel tolerance):

* each fused head route (:func:`head_checks`): ``head_sm90_kernel`` on a
  bf16 volume and ``head_sm90_f32_kernel`` on an fp32 volume, read in place
  (kernel ``fused_head_sm90``, ``fused_head_sm90_f32``), and the same kernels
  through the repitch routes on the same volumes placed 4 bytes past a
  16-byte boundary (``fused_head_sm90_repitch``, ``fused_head_sm90_f32_repitch``);
* ``band_kernel`` on an fp32 cost (:func:`band_checks`; kernel
  ``band_soft_argmin``);
* the in-model fused path (:func:`in_model_checks`): ``best_sceneflow_model``
  at 384x1248, bf16, seeded weights; the volume and kernel the model hands
  its fused head are captured, and the model's map is held against float64
  on exactly those, with the ``last_3`` kernel as calibrated (peaky), 10x
  (wide) and 0.1x (diffuse).

Writes a JSON shaped like ``KERNEL_PARITY_r05.json``: ``device``, ``shape``,
per check ``max_abs_err``, ``atol`` and ``ok``, and ``all_ok``. The run
raises without a CUDA card; the check functions take tensors on any device
(on the CPU every wrapper runs its plain version), which is how the tests
check the JSON document. ``chip_smoke.py`` phases 3 and 4 call the same
functions.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

__all__ = [
    "ATOL_PX",
    "KINDS",
    "KITTI",
    "WIDE",
    "band_checks",
    "band_cost",
    "calibrate_head",
    "head_checks",
    "HEAD_ROUTES",
    "head_inputs",
    "in_model_checks",
    "main",
    "offset_copy",
    "peaky_cost",
    "report",
    "ROUTE_SHAPES",
    "run",
]

ATOL_PX = 2e-3
KINDS = ("peaky", "wide", "diffuse")
WIDE = 10.0  # scale of the "wide" inputs' cost (a span of ~250 units at D = 64)
KITTI = dict(b=1, c=32, d=64, h=128, w=416, maxdisp=192)  # 384x1248 at 1/3 resolution
# The in-model check's last_3 scales: as calibrated, wide, diffuse.
MODEL_SCALES = {"peaky": 1.0, "wide": WIDE, "diffuse": 0.1}


def peaky_cost(gen: torch.Generator, b: int, d: int, h: int, w: int, dev) -> torch.Tensor:
    """Trained-like unimodal cost plus noise (as tests/test_pallas_softargmin.py)."""
    best = torch.randint(0, d, (b, 1, h, w), generator=gen, device=dev)
    planes = torch.arange(d, device=dev).view(1, d, 1, 1)
    return 0.35 * (planes - best).abs().float() + 0.8 * torch.randn(b, d, h, w, generator=gen, device=dev)


def head_inputs(gen: torch.Generator, kind: str, b: int, c: int, d: int, h: int, w: int, dev):
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


def band_cost(gen: torch.Generator, kind: str, b: int, d: int, h: int, w: int, dev) -> torch.Tensor:
    """A (B, D, h, w) cost of ``kind``: peaky, peaky scaled WIDE, or random."""
    if kind == "diffuse":
        return torch.randn(b, d, h, w, generator=gen, device=dev)
    return peaky_cost(gen, b, d, h, w, dev) * (WIDE if kind == "wide" else 1.0)


def _check(name: str, kernel: str, kind: str, dtype, shape, err: float) -> dict:
    return {"check": name, "kernel": kernel, "input": kind, "dtype": str(dtype), "shape": list(shape),
            "max_abs_err": err, "atol": ATOL_PX, "ok": bool(err < ATOL_PX)}


def _max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return (got.double() - ref).abs().max().item()


def offset_copy(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts ``nbytes`` (a multiple of
    its element size) past the start of its buffer."""
    k = nbytes // x.element_size()
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    out = buf[k:].view(x.shape)
    out.copy_(x)
    return out


# Volumes no sm90 route took before channel padding, channel groups and the
# repitch routes, at KITTI size: name -> ((B, C, D, h, w), volume dtype name,
# bytes past a 16-byte boundary). C = 24 and 12 pad to 32 and 16 (12: the
# search's widths), 80 takes 32-channel groups; w = 412 (bf16) and 414 (fp32)
# are not whole 16-byte rows, and "unaligned" starts off a 16-byte boundary.
ROUTE_SHAPES = {
    "c24": ((1, 24, 64, 128, 416), "bfloat16", 0),
    "c12_search_widths": ((1, 12, 64, 128, 416), "bfloat16", 0),
    "c80_groups": ((1, 80, 64, 128, 416), "bfloat16", 0),
    "w412": ((1, 32, 64, 128, 412), "bfloat16", 0),
    "w414_f32": ((1, 32, 64, 128, 414), "float32", 0),
    "unaligned": ((1, 24, 64, 128, 416), "bfloat16", 4),
}

# Each fused head route's check: (kernel name, route, volume dtype, bytes
# past a 16-byte boundary).
HEAD_ROUTES = (("fused_head_sm90", "sm90", torch.bfloat16, 0),
               ("fused_head_sm90_f32", "sm90_f32", torch.float32, 0),
               ("fused_head_sm90_repitch", "sm90_repitch", torch.bfloat16, 4),
               ("fused_head_sm90_f32_repitch", "sm90_f32_repitch", torch.float32, 4))


def head_checks(gen: torch.Generator, b: int, c: int, d: int, h: int, w: int, maxdisp: int, dev) -> list[dict]:
    """Each fused head route against the float64 plain version, on each kind
    of input: the in-place routes on the volume type each takes, the
    repitch routes on the same volumes 4 bytes past a 16-byte boundary."""
    from ..ops.fused_head import ROUTE_WRAPPERS, conv_soft_argmin_reference

    out = []
    for kind in KINDS:
        vol32, kern = head_inputs(gen, kind, b, c, d, h, w, dev)
        for name, route, dt, offset in HEAD_ROUTES:
            vol = offset_copy(vol32.to(dt), offset)
            fn = ROUTE_WRAPPERS[route]
            err = _max_err(fn(vol, kern, maxdisp), conv_soft_argmin_reference(vol.double(), kern.double(), maxdisp))
            check = _check(f"{name}_{kind}_vs_f64", name, kind, dt, vol.shape, err)
            check["route"], check["offset_bytes"] = route, offset
            out.append(check)
    return out


def band_checks(gen: torch.Generator, b: int, d: int, h: int, w: int, maxdisp: int, dev) -> list[dict]:
    """The band kernel against the float64 plain version on each kind of cost."""
    from ..ops.fused_softargmin import soft_argmin_cuda
    from ..ops.softargmin import soft_argmin

    out = []
    for kind in KINDS:
        cost = band_cost(gen, kind, b, d, h, w, dev)
        err = _max_err(soft_argmin_cuda(cost, maxdisp), soft_argmin(cost.double(), maxdisp))
        out.append(_check(f"band_soft_argmin_{kind}_vs_f64", "band_soft_argmin", kind, torch.float32, cost.shape, err))
    return out


def calibrate_head(model, left: torch.Tensor, right: torch.Tensor) -> None:
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


def in_model_checks(model, left: torch.Tensor, right: torch.Tensor) -> list[dict]:
    """The model's eval forward through its fused head, against float64 on
    the exact volume and kernel the model hands that head, with the
    ``last_3`` kernel scaled by each of ``MODEL_SCALES`` in turn (restored
    after). The model must take the fused head (eval, no entropy, no fast
    head, no pspec, a shape a fused-head route admits)."""
    from ..models import leastereo
    from ..ops.fused_head import conv_soft_argmin_reference, fused_head_route

    seen = []
    fused = leastereo.conv_soft_argmin_fused

    def capture(vol, kernel, maxdisp):
        seen.append((vol, kernel))
        return fused(vol, kernel, maxdisp)

    weight = model.matching.last_3.conv.weight
    saved = weight.detach().clone()
    out = []
    leastereo.conv_soft_argmin_fused = capture
    try:
        for kind, scale in MODEL_SCALES.items():
            with torch.no_grad():
                weight.copy_(saved * scale)
            seen.clear()
            with torch.inference_mode():
                disp = model(left, right)
            if len(seen) != 1:
                raise AssertionError(f"the model called its fused head {len(seen)} times, not once")
            vol, kernel = seen[0]
            ref = conv_soft_argmin_reference(vol.double(), kernel.double(), model.config.maxdisp)
            check = _check(f"in_model_fused_{kind}_vs_f64", "in_model_fused", kind, vol.dtype, vol.shape,
                           _max_err(disp, ref))
            _, c, d, _, w = vol.shape
            check["route"] = fused_head_route(c, d, w, model.config.maxdisp, vol.dtype)
            check["last_3_scale"] = scale
            out.append(check)
    finally:
        leastereo.conv_soft_argmin_fused = fused
        with torch.no_grad():
            weight.copy_(saved)
    return out


def report(checks: list[dict], device: str, shape: dict) -> dict:
    """The JSON document of ``checks`` (each with a unique ``check`` name)."""
    kernels = {c["check"]: {k: v for k, v in c.items() if k != "check"} for c in checks}
    if len(kernels) != len(checks):
        raise ValueError("check names are not unique")
    return {"device": device, "shape": shape, "kernels": kernels, "all_ok": all(c["ok"] for c in checks)}


def run() -> dict:
    """Every check at the KITTI shapes on the card; the JSON document.
    Raises without a CUDA card: the checks are of the compiled kernels."""
    from ..models.leastereo import LEAStereoConfig, best_sceneflow_model, require_cuda
    from ..ops import _build

    require_cuda()
    _build.load_kernels()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    s = KITTI
    checks = head_checks(gen, s["b"], s["c"], s["d"], s["h"], s["w"], s["maxdisp"], dev)
    checks += band_checks(gen, s["b"], s["d"], s["h"], s["w"], s["maxdisp"], dev)
    torch.cuda.empty_cache()
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=s["maxdisp"], compute_dtype="bfloat16"), seed=0)
    left, right = (torch.randn(1, 3 * s["h"], 3 * s["w"], 3, generator=gen, device=dev) for _ in range(2))
    calibrate_head(model, left, right)
    checks += in_model_checks(model, left, right)
    return report(checks, torch.cuda.get_device_name(0), s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="KERNEL_PARITY.json")
    args = ap.parse_args(argv)
    doc = run()
    for name, c in doc["kernels"].items():
        print(f"{name:48s} max|err| = {c['max_abs_err']:.3e} (atol {c['atol']})  {'OK' if c['ok'] else 'FAIL'}")
    pathlib.Path(args.out).write_text(json.dumps(doc, indent=1))
    print(f"wrote {args.out}  all_ok={doc['all_ok']}")
    return 0 if doc["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
