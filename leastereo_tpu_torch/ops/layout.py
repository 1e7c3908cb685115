"""The 3-D volumes' layouts: NCDHW (contiguous) or NDHWC
(``torch.channels_last_3d``), which the eval matching net keeps so that
cuDNN convolves in place (``models/matching_net.py``). The ops that take a
volume follow its layout; these helpers say which one it has and join
volumes along their channels in it."""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.tracing import compiler_tracing
from . import _build

__all__ = ["is_ndhwc", "cat_channels", "cat_ndhwc_cuda"]

_CAT_MAX = 8  # inputs of one launch of the kernel (csrc/ndhwc.cu CAT_MAX)


def is_ndhwc(x: torch.Tensor) -> bool:
    """Whether ``x`` is a 5-D volume laid out NDHWC (``channels_last_3d``)
    and not also NCDHW-contiguous (as a volume of one channel or one voxel is)."""
    return x.ndim == 5 and x.is_contiguous(memory_format=torch.channels_last_3d) and not x.is_contiguous()


def cat_channels(xs: list[torch.Tensor]) -> torch.Tensor:
    """``torch.cat(xs, dim=1)`` in the volumes' layout: NDHWC CUDA volumes
    through :func:`cat_ndhwc_cuda` (but while a compiler traces), any others
    through ``torch.cat``, whose values are the same."""
    if (1 < len(xs) <= _CAT_MAX and xs[0].is_cuda and all(is_ndhwc(x) for x in xs)
            and not compiler_tracing()):
        return cat_ndhwc_cuda(xs)
    return torch.cat(xs, dim=1)


def cat_ndhwc_cuda(xs: list[torch.Tensor]) -> torch.Tensor:
    """Kernel ``lst_cat_ndhwc`` (``csrc/ndhwc.cu``): NDHWC CUDA volumes of one
    type and one ``(B, D, H, W)``, at most 8, joined along their channels
    into an NDHWC volume; ``torch.cat(xs, dim=1)`` is its plain version.
    Raises on any other volumes. ``.launches`` counts the launches."""
    x0 = xs[0]
    alike = all(x.device == x0.device and x.dtype == x0.dtype and is_ndhwc(x) for x in xs)
    one_size = len({(x.shape[0], *x.shape[2:]) for x in xs}) == 1
    if not (1 <= len(xs) <= _CAT_MAX and x0.device.type == "cuda" and x0.dtype in _build.NDHWC_DTYPES
            and alike and one_size):
        raise ValueError(f"the NDHWC cat takes 1 to {_CAT_MAX} NDHWC CUDA volumes of one type and size, got "
                         f"{[(tuple(x.shape), x.dtype, str(x.device)) for x in xs]}")
    b, _, d, h, w = x0.shape
    channels = [x.shape[1] for x in xs]
    out = torch.empty((b, sum(channels), d, h, w), dtype=x0.dtype, device=x0.device,
                      memory_format=torch.channels_last_3d)
    vec = _build.ndhwc_vec(math.gcd(*channels), *xs, out)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        err = lib.lst_cat_ndhwc((ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs)),
                                (ctypes.c_int * len(xs))(*channels), len(xs), out.data_ptr(),
                                _build.NDHWC_DTYPES[x0.dtype], vec, b * d * h * w, stream)
    _build.check(err, "NDHWC cat kernel")
    cat_ndhwc_cuda.launches += 1
    return out


cat_ndhwc_cuda.launches = 0
