"""Fused cost-volume construction + matching-stem convolution
(port of ``leastereo_tpu/ops/fused_stem.py``, unpacked form).

The concat volume (``ops/cost_volume.py``) is a shear of two 2-D signals::

    vol[:C, d, h, w] = L[h, w]      * 1[w >= d]
    vol[C:, d, h, w] = R[h, w - d]  * 1[w >= d]

so a 3x3x3 convolution over it collapses exactly into 2-D convolutions of
``L`` and ``R`` plus an assembly that depends only on the diagonal offset
``j = w - d`` (derivation in the JAX module's docstring):

* Left half: per depth tap ``kd`` the mask suppresses the ``t = clamp(kd - j,
  0, 3)`` left-most column taps, so the left contribution at ``(d, w)`` is a
  sum of partial-width convs ``P[t][kd]`` at column ``w``, chosen by ``j``'s
  class (``j <= -3, -2, -1, 0, 1, >= 2``) and by which ``kd`` are inside the
  depth range at ``d``.
* Right half: tap ``kd`` reads ``CR[kd]`` (a conv of ``R``) at column
  ``j - kd + 3``; summed over the valid ``kd`` this is one 2-D map ``G`` of
  ``(h, j)``. One wrong read, the ``kw = +1`` tap at ``w = W-1`` which should
  see the volume's zero column ``w' = W``, is subtracted afterwards.

The JAX function unrolls the ``num_disp`` planes statically, which in eager
PyTorch would be hundreds of small launches. Here the assembly is vectorised:
both halves are one ``index_select`` each from small tables of 2-D maps, with
index tensors over ``(d, h, w)``, written straight into the NCDHW output.
The volume never exists. Not a kernel of the TPU build either: it stays
PyTorch (cuDNN 2-D convs plus gathers). An NDHWC output
(``memory_format=torch.channels_last_3d``, the eval matching net's) comes
from tables of ``F``-channel rows: on the card one kernel
(:func:`stem_ndhwc_cuda`) writes it, with the fix, the bias and the ReLU,
where PyTorch's gather of 64-byte rows takes a block a row; elsewhere the
NCDHW output, then one conversion.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.tracing import compiler_tracing
from . import _build

__all__ = ["fused_cost_volume_stem", "stem_ndhwc_cuda"]

_N_CLASSES = 6  # diagonal classes j <= -3, -2, -1, 0, 1, >= 2
# The depth taps inside [0, D) at a plane that is neither end, the first,
# the last, or both (D = 1): the kernel's plane categories.
_CATEGORY_TAPS = ((0, 1, 2), (1, 2), (0, 1), (1,))


def _by_kd(wt: torch.Tensor) -> torch.Tensor:
    """``(F, C, kd, kh, kw') -> (3F, C, kh, kw')``: the three depth taps as
    output-channel blocks of one 2-D conv (block ``kd`` at rows ``kd*F``)."""
    f, c, kd, kh, kw = wt.shape
    return wt.permute(2, 0, 1, 3, 4).reshape(kd * f, c, kh, kw)


def _conv_kd(x: torch.Tensor, wt: torch.Tensor, pad: tuple[int, int, int, int]) -> torch.Tensor:
    """2-D conv of ``x`` (padded by ``pad``, F.pad order) with the three depth
    taps of ``wt``; returns ``(B, 3, F, H', W')``."""
    y = F.conv2d(F.pad(x, pad), _by_kd(wt))
    return y.view(y.shape[0], 3, wt.shape[0], *y.shape[2:])


def fused_cost_volume_stem(
    left: torch.Tensor,
    right: torch.Tensor,
    kernel: torch.Tensor,
    num_disp: int,
    bias: torch.Tensor | None = None,
    relu: bool = False,
    planes: tuple[int, int] | None = None,
    memory_format: torch.memory_format = torch.contiguous_format,
) -> torch.Tensor:
    """``conv3d(build_cost_volume(left, right, num_disp), kernel, padding=1)``
    without materialising the volume.

    Args:
      left, right: NCHW ``(B, C, H, W)`` feature maps.
      kernel: OIDHW ``(F, 2C, 3, 3, 3)`` stem kernel.
      num_disp: volume depth ``D``.
      bias: optional ``(F,)`` epilogue bias (the eval-folded BN bias).
      relu: apply the stem ReLU in the same epilogue.
      planes: the global planes ``[lo, hi)`` to compute (a rank's slab of a
        disparity-sharded volume); default all ``D``. The neighbour planes
        the depth taps read come from the features here, with no exchange,
        and the volume is zero beyond ``[0, D)``.
      memory_format: of the output: ``torch.contiguous_format`` (NCDHW) or
        ``torch.channels_last_3d`` (NDHWC); the same values either way.

    Returns:
      ``(B, F, hi - lo, H, W)``.
    """
    b, c, h, w = left.shape
    f = kernel.shape[0]
    nd = num_disp
    lo, hi = planes if planes is not None else (0, nd)
    if not 0 <= lo < hi <= nd:
        raise ValueError(f"planes [{lo}, {hi}) outside [0, {nd})")
    if tuple(kernel.shape[1:]) != (2 * c, 3, 3, 3):
        raise ValueError(f"expected ({f}, {2 * c}, 3, 3, 3) kernel, got {tuple(kernel.shape)}")
    kernel = kernel.to(left.dtype)
    wl, wr = kernel[:, :c], kernel[:, c:]
    dev = left.device

    # Partial-width convs of L: p[t][:, kd] drops the t left-most kw taps.
    p = [
        _conv_kd(left, wl, (1, 1, 1, 1)),
        _conv_kd(left, wl[..., 1:], (0, 1, 1, 1)),
        _conv_kd(left, wl[..., 2:], (-1, 1, 1, 1)),
    ]
    # CR[:, kd][h, j'] = sum_{kh,kw} wr * R[h+kh-1, j'+kw-3], j' in [0, W+4),
    # left-padded by D zero columns so any diagonal reads in range.
    cr = F.pad(_conv_kd(right, wr, (3, 3, 1, 1)), (nd, 0))
    corr = _conv_kd(right, wr[..., 2:], (0, 0, 1, 1))  # the kw = +1 tap alone

    # Plane types: which depth taps kd land inside [0, D) at plane d.
    valid_sets: list[tuple[int, ...]] = []
    ptype = []
    for d in range(lo, hi):
        v = tuple(kd for kd in range(3) if 0 <= d + kd - 1 < nd)
        if v not in valid_sets:
            valid_sets.append(v)
        ptype.append(valid_sets.index(v))
    n_types = len(valid_sets)

    zero = left.new_zeros((b, f, h, w))
    left_maps, right_maps = [], []
    for v in valid_sets:
        for k in range(_N_CLASSES):
            j = k - 3  # taps suppressed at this diagonal: t = max(kd - j, 0)
            terms = [p[max(kd - j, 0)][:, kd] for kd in v if kd - j < 3]
            left_maps.append(sum(terms[1:], terms[0]) if terms else zero)
        g = [cr[:, kd, :, :, 4 - kd : 4 - kd + w + nd - 1] for kd in v]
        right_maps.append(sum(g[1:], g[0]))
    wg = w + nd - 1
    if memory_format not in (torch.contiguous_format, torch.channels_last_3d):
        raise ValueError(f"memory_format {memory_format}: the stem writes NCDHW or NDHWC")

    # Right-edge fix: at w = W-1 the kw = +1 tap read R[u], u = W+1-d-kd,
    # where the volume holds its zero column w' = W.
    dd = torch.arange(lo, hi, device=dev)
    fix = None
    for kd in range(3):
        u = w + 1 - kd - dd
        ok = (u >= 0) & (u < w) & (dd + kd - 1 >= 0) & (dd + kd - 1 < nd)
        term = corr[:, kd].index_select(3, u.clamp(0, w - 1)) * ok.to(left.dtype)
        fix = term if fix is None else fix + term  # (B, F, H, planes)

    # An NDHWC output on the card: the kernel, from tables of F-channel rows
    # (B, T*6*H*W, F), (B, T*H*wg, F). A compiler traces the PyTorch ops
    # below, whose result is the kernel's.
    if memory_format == torch.channels_last_3d and left.is_cuda and not compiler_tracing():
        left_tab = torch.stack([m.permute(0, 2, 3, 1) for m in left_maps], dim=1).reshape(b, -1, f)
        right_tab = torch.stack([m.permute(0, 2, 3, 1) for m in right_maps], dim=1).reshape(b, -1, f)
        out = stem_ndhwc_cuda(left_tab, right_tab, fix.permute(0, 3, 2, 1).contiguous(), bias, relu,
                              valid_sets, (lo, hi), nd, h, w)
        return out.permute(0, 4, 1, 2, 3)

    left_tab = torch.stack(left_maps, dim=2).reshape(b, f, -1)  # (B, F, T*6*H*W)
    right_tab = torch.stack(right_maps, dim=2).reshape(b, f, -1)  # (B, F, T*H*wg)
    pt = torch.tensor(ptype, device=dev).view(-1, 1, 1)
    dd = dd.view(-1, 1, 1)
    hh = torch.arange(h, device=dev).view(1, h, 1)
    ww = torch.arange(w, device=dev).view(1, 1, w)
    cls = (ww - dd + 3).clamp(0, _N_CLASSES - 1)
    idx_left = ((pt * _N_CLASSES + cls) * h + hh) * w + ww
    idx_right = (pt * h + hh) * wg + (ww - dd + nd - 1)
    out = left_tab.index_select(2, idx_left.reshape(-1))
    out += right_tab.index_select(2, idx_right.reshape(-1))
    out = out.view(b, f, hi - lo, h, w)
    out[..., w - 1] -= fix.permute(0, 1, 3, 2)

    if bias is not None:
        out += bias.to(out.dtype).view(1, f, 1, 1, 1)
    if relu:
        out.relu_()
    return out.contiguous(memory_format=memory_format)


def stem_ndhwc_cuda(
    left_tab: torch.Tensor,
    right_tab: torch.Tensor,
    fix: torch.Tensor,
    bias: torch.Tensor | None,
    relu: bool,
    valid_sets: list[tuple[int, ...]],
    planes: tuple[int, int],
    num_disp: int,
    h: int,
    w: int,
) -> torch.Tensor:
    """Kernel ``lst_stem_ndhwc`` (``csrc/ndhwc.cu``): the NDHWC stem output
    ``(B, planes, H, W, F)``, contiguous, assembled from the tables of
    :func:`fused_cost_volume_stem` (``left_tab`` ``(B, T*6*H*W, F)``,
    ``right_tab`` ``(B, T*H*(W+D-1), F)``, ``valid_sets`` their T plane
    types), the right-edge ``fix`` ``(B, planes, H, F)``, the ``bias`` and the
    ReLU, bit for bit as that function's PyTorch ops assemble it (its plain
    version, which runs on the CPU). ``.launches`` counts the launches."""
    b, _, f = left_tab.shape
    lo, hi = planes
    dtype = left_tab.dtype
    if left_tab.device.type != "cuda" or dtype not in _build.NDHWC_DTYPES:
        raise ValueError(f"the NDHWC stem takes CUDA tables of {sorted(map(str, _build.NDHWC_DTYPES))}, "
                         f"got {dtype} on {left_tab.device}")
    bias = None if bias is None else bias.to(dtype).contiguous()
    tensors = [t.contiguous() for t in (left_tab, right_tab, fix)]
    out = torch.empty((b, hi - lo, h, w, f), dtype=dtype, device=left_tab.device)
    vec = _build.ndhwc_vec(f, *tensors, out, *([] if bias is None else [bias]))
    types = [valid_sets.index(t) if t in valid_sets else 0 for t in _CATEGORY_TAPS]
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        err = lib.lst_stem_ndhwc(*(t.data_ptr() for t in tensors), None if bias is None else bias.data_ptr(),
                                 out.data_ptr(), _build.NDHWC_DTYPES[dtype], vec, b, f, hi - lo, h, w, lo, num_disp,
                                 len(valid_sets), *types, int(relu), stream)
    _build.check(err, "NDHWC stem kernel")
    stem_ndhwc_cuda.launches += 1
    return out


stem_ndhwc_cuda.launches = 0
