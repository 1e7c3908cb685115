"""Interpolation ops (port of ``leastereo_tpu/ops/resize.py``).

The JAX package rebuilds PyTorch's ``F.interpolate`` semantics from dense
interpolation matrices; here ``F.interpolate`` itself is the semantics. Every
resize passes an explicit output size, so no scale-factor rounding enters.
Layouts are NCHW (2-D) and NCDHW or NDHWC (3-D, ``channels_last_3d``); a
3-D resize keeps its input's layout. An NDHWC volume on the card takes the
kernel ``csrc/ndhwc.cu`` (:func:`resize3d_ndhwc_cuda`): PyTorch's
trilinear kernel walks such a volume one channel at a time.

A rank's slab of a disparity-sharded volume is resized by
:func:`resize3d` given its partition: bilinear in (H, W) on the fetched
source planes, then linear along D at the *global* align_corners=True
coordinates. ``F.interpolate`` on the slab alone would place the planes at
the slab's own coordinates.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.halo import DispPartition, fetch_planes
from ..utils.tracing import compiler_tracing
from . import _build
from .layout import is_ndhwc

__all__ = ["scale_dimension", "resize2d", "resize3d", "resize3d_ndhwc_cuda", "resize3d_ndhwc", "upsample3x_axis"]


def scale_dimension(dim: int, scale: float) -> int:
    """Reference's odd-dimension-aware scaling rule
    (``retrain/new_model_2d.py:38-39``): odd dims map ``d -> (d-1)*s + 1`` so
    align_corners=True resizing stays on the corner grid; even dims map
    ``d -> int(d*s)``."""
    return int((float(dim) - 1.0) * scale + 1.0) if dim % 2 == 1 else int(float(dim) * scale)


def resize2d(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``out_hw``."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners)


def resize3d(
    x: torch.Tensor,
    out_dhw: tuple[int, int, int],
    align_corners: bool = True,
    part: DispPartition | None = None,
    memory_format: torch.memory_format | None = None,
) -> torch.Tensor:
    """Trilinear resize of an NCDHW or NDHWC tensor to ``out_dhw``, laid out
    as ``memory_format`` says (unsharded; ``None``: as ``x``). An NDHWC CUDA
    volume goes through :func:`resize3d_ndhwc_cuda` (a compiler traces it as
    ``torch.ops.leastereo.resize3d_ndhwc``), which writes either layout; any
    other through ``F.interpolate``.

    With ``part``, ``x`` is rank ``part.rank``'s slab of a volume of
    ``part.depth`` planes sharded along D, and the result is its slab of the
    resized volume (``out_dhw[0]`` planes over the same ranks)."""
    if part is None:
        if tuple(x.shape[2:]) == tuple(out_dhw):
            return x if memory_format is None else x.contiguous(memory_format=memory_format)
        if x.is_cuda and align_corners and is_ndhwc(x):
            fmt = memory_format or torch.channels_last_3d
            if compiler_tracing():
                return torch.ops.leastereo.resize3d_ndhwc(x, list(out_dhw), fmt == torch.contiguous_format)
            return resize3d_ndhwc_cuda(x, out_dhw, fmt)
        y = F.interpolate(x, size=tuple(out_dhw), mode="trilinear", align_corners=align_corners)
        return y if memory_format is None else y.contiguous(memory_format=memory_format)
    if not align_corners:
        raise ValueError("the sharded resize follows the model's align_corners=True grid only")
    n_in, n_out = part.depth, out_dhw[0]
    out_part = part.of_depth(n_out)
    # PyTorch's trilinear arithmetic (upsample_trilinear3d, align_corners):
    # a scale in the op's math type (float32; float64 for float64 input),
    # the source coordinate scale * p, its integer part and weights in that
    # type; each source plane resized bilinearly in (H, W), then
    # the two planes blended as lambda0 * a + lambda1 * b in one fused
    # multiply-add (addcmul). On the card this reproduces F.interpolate's
    # result bit for bit, so a sharded volume's planes are the unsharded ones.
    opmath = torch.float64 if x.dtype == torch.float64 else torch.float32
    scale = torch.tensor(float(n_in - 1) if n_out > 1 else 0.0, dtype=opmath) / max(n_out - 1, 1)

    def first(p: int) -> int:  # the lower source plane of output plane p
        return min(int(scale * p), n_in - 1)

    bounds = out_part.bounds
    lo = [first(a) for a, _ in bounds]
    hi = [min(first(b - 1) + 2, n_in) for _, b in bounds]
    src = fetch_planes(x, part, lo, hi)
    bsz, c, n, h, w = src.shape
    if (h, w) != tuple(out_dhw[1:]):
        src = F.interpolate(src.transpose(1, 2).reshape(bsz * n, c, h, w), size=tuple(out_dhw[1:]),
                            mode="bilinear", align_corners=True)
        src = src.view(bsz, n, c, *out_dhw[1:]).transpose(1, 2)
    pos = scale * torch.arange(out_part.lo, out_part.hi, dtype=opmath)
    i0 = pos.long()
    lam1 = pos - i0.to(opmath)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    base = lo[part.rank]
    a = src.index_select(2, (i0 - base).to(x.device))
    b = src.index_select(2, (i1 - base).to(x.device))
    lam0, lam1 = ((v.view(1, 1, -1, 1, 1).to(device=x.device, dtype=x.dtype)) for v in (1.0 - lam1, lam1))
    return torch.addcmul(lam1 * b, lam0, a)


def _align_corners_scale(n_in: int, n_out: int, dtype: torch.dtype) -> float:
    """PyTorch's ``area_pixel_compute_scale`` (align_corners): ``(n_in - 1) /
    (n_out - 1)`` in the kernel's accumulation type (float32; float64 for
    float64), 0 for an output of one."""
    if n_out <= 1:
        return 0.0
    if dtype == torch.float64:
        return (n_in - 1) / (n_out - 1)
    return float(np.float32(n_in - 1) / np.float32(n_out - 1))


def resize3d_ndhwc_cuda(x: torch.Tensor, out_dhw: tuple[int, int, int],
                        memory_format: torch.memory_format = torch.channels_last_3d) -> torch.Tensor:
    """Kernel ``lst_resize_ndhwc``: the trilinear, align_corners=True resize
    of an NDHWC (``channels_last_3d``) CUDA volume ``(B, C, D, H, W)`` of a
    floating type to ``out_dhw``, written NDHWC or, with ``memory_format``
    ``torch.contiguous_format``, NCDHW, with ``F.interpolate``'s arithmetic
    (``csrc/ndhwc.cu``); ``F.interpolate`` is its plain version, which
    :func:`resize3d` runs on the CPU. Raises on any other volume.
    ``.launches`` counts the launches."""
    if x.device.type != "cuda" or not is_ndhwc(x) or x.dtype not in _build.NDHWC_DTYPES:
        raise ValueError(f"the NDHWC resize takes an NDHWC CUDA volume of {sorted(map(str, _build.NDHWC_DTYPES))}, "
                         f"got {x.dtype} on {x.device}, strides {x.stride()}")
    if memory_format not in (torch.channels_last_3d, torch.contiguous_format):
        raise ValueError(f"the NDHWC resize writes NDHWC or NCDHW, not {memory_format}")
    b, c, d1, h1, w1 = x.shape
    d2, h2, w2 = (int(n) for n in out_dhw)
    y = torch.empty((b, c, d2, h2, w2), dtype=x.dtype, device=x.device, memory_format=memory_format)
    vec = _build.ndhwc_vec(c, x)
    scales = (_align_corners_scale(n, m, x.dtype) for n, m in ((d1, d2), (h1, h2), (w1, w2)))
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.lst_resize_ndhwc(x.data_ptr(), y.data_ptr(), _build.NDHWC_DTYPES[x.dtype], vec,
                                   int(memory_format == torch.contiguous_format),
                                   b, c, d1, h1, w1, d2, h2, w2, *scales, stream)
    _build.check(err, "NDHWC resize kernel")
    resize3d_ndhwc_cuda.launches += 1
    return y


resize3d_ndhwc_cuda.launches = 0


@torch.library.custom_op("leastereo::resize3d_ndhwc", mutates_args=(), device_types="cuda")
def resize3d_ndhwc(x: torch.Tensor, out_dhw: list[int], ncdhw: bool) -> torch.Tensor:
    """``torch.ops.leastereo.resize3d_ndhwc``: :func:`resize3d_ndhwc_cuda`
    (output NCDHW with ``ncdhw``, else NDHWC), as a traced graph
    (``torch.export``) holds it; the eager forward calls the wrapper itself."""
    return resize3d_ndhwc_cuda(x, out_dhw, torch.contiguous_format if ncdhw else torch.channels_last_3d)


@resize3d_ndhwc.register_fake
def _resize3d_ndhwc_fake(x, out_dhw, ncdhw):
    fmt = torch.contiguous_format if ncdhw else torch.channels_last_3d
    return torch.empty((*x.shape[:2], *out_dhw), dtype=x.dtype, device=x.device, memory_format=fmt)


def upsample3x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 3x linear upsample along ``axis`` (align_corners=False).

    Output position ``3i + r`` has source ``i + (r-1)/3``: phase 0 blends
    ``x[i-1]`` and ``x[i]`` 1/3 : 2/3, phase 1 is ``x[i]``, phase 2 blends
    ``x[i]`` and ``x[i+1]`` 2/3 : 1/3, with edge clamping.
    """
    axis = axis % x.ndim
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    r0 = (1.0 / 3.0) * prev + (2.0 / 3.0) * x
    r2 = (2.0 / 3.0) * x + (1.0 / 3.0) * nxt
    out = torch.stack([r0, x, r2], dim=axis + 1)
    return out.reshape(*x.shape[:axis], 3 * n, *x.shape[axis + 1 :])
