"""The port's heads as ``torch.library`` custom ops, on the CPU.

``torch.ops.leastereo.conv_soft_argmin`` (fused head) and
``torch.ops.leastereo.band_soft_argmin`` (band kernel) pass
``torch.library.opcheck``; their fake implementations give the output's
shape and dtype without building or loading the kernel library or counting
a launch; their gradients are the plain versions' gradients, bit for bit;
and a model counts the same FLOPs with the head fused or not. The card's
side is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.ops import _build
from leastereo_tpu_torch.ops.fused_head import (
    conv_soft_argmin_fused,
    conv_soft_argmin_reference,
    conv_soft_argmin_simt,
    conv_soft_argmin_sm90,
    conv_soft_argmin_sm90_f32,
)
from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda, soft_argmin_fused
from leastereo_tpu_torch.ops.softargmin import soft_argmin

COUNTERS = (conv_soft_argmin_sm90, conv_soft_argmin_sm90_f32, conv_soft_argmin_simt, soft_argmin_cuda)


def _head_inputs(dtype, seed=0):
    rng = np.random.RandomState(seed)
    vol = torch.from_numpy(rng.randn(2, 4, 8, 5, 7).astype(np.float32)).to(dtype)
    kern = torch.from_numpy((0.3 * rng.randn(1, 4, 3, 3, 3)).astype(np.float32)).to(dtype)
    return vol.requires_grad_(True), kern.requires_grad_(True)


def _cost(dtype=torch.float32, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randn(2, 8, 5, 7).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_soft_argmin_opcheck(dtype):
    vol, kern = _head_inputs(dtype)
    torch.library.opcheck(torch.ops.leastereo.conv_soft_argmin.default, (vol, kern, 24))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_soft_argmin_opcheck(dtype):
    torch.library.opcheck(torch.ops.leastereo.band_soft_argmin.default, (_cost(dtype).requires_grad_(True), 24))


def test_fake_implementations_give_shape_without_the_library(monkeypatch):
    """Tracing (torch.export, the FLOP counter) runs the fake implementations:
    they never build or load the kernels and count no launch."""

    def no_library():
        raise AssertionError("a fake implementation loaded the kernel library")

    monkeypatch.setattr(_build, "load_kernels", no_library)
    n = [f.launches for f in COUNTERS]
    with FakeTensorMode():
        for dtype in (torch.float32, torch.bfloat16):
            out = torch.ops.leastereo.conv_soft_argmin(torch.empty(3, 16, 8, 5, 7, dtype=dtype),
                                                       torch.empty(1, 16, 3, 3, 3), 24)
            assert out.shape == (3, 15, 21) and out.dtype == torch.float32
        for dtype in (torch.float32, torch.bfloat16):
            out = torch.ops.leastereo.band_soft_argmin(torch.empty(3, 8, 5, 7, dtype=dtype), 24)
            assert out.shape == (3, 15, 21) and out.dtype == torch.float32
        with pytest.raises(ValueError, match="expected"):
            torch.ops.leastereo.band_soft_argmin(torch.empty(8, 5, 7), 24)
        with pytest.raises(ValueError, match="expected"):
            torch.ops.leastereo.conv_soft_argmin(torch.empty(3, 16, 8, 5, 7), torch.empty(1, 8, 3, 3, 3), 24)
    assert [f.launches for f in COUNTERS] == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_gradients_are_the_plain_versions(dtype):
    vol, kern = _head_inputs(dtype)
    g = torch.from_numpy(np.random.RandomState(2).randn(2, 15, 21).astype(np.float32))
    out = conv_soft_argmin_fused(vol, kern, 24)
    got = torch.autograd.grad(out, (vol, kern), g)
    v, k = vol.detach().requires_grad_(True), kern.detach().requires_grad_(True)
    ref_out = conv_soft_argmin_reference(v, k, 24)
    want = torch.autograd.grad(ref_out, (v, k), g)
    assert torch.equal(out, ref_out)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_gradient_is_the_plain_versions(dtype):
    """A bf16 cost's gradient comes back as bf16, as from ``soft_argmin``."""
    g = torch.from_numpy(np.random.RandomState(3).randn(2, 15, 21).astype(np.float32))
    cost = _cost(dtype).requires_grad_(True)
    out = soft_argmin_fused(cost, 24)
    (got,) = torch.autograd.grad(out, cost, g)
    c = cost.detach().requires_grad_(True)
    ref_out = soft_argmin(c, 24)
    (want,) = torch.autograd.grad(ref_out, c, g)
    assert torch.equal(out, ref_out)
    assert got.dtype == dtype and torch.equal(got, want)


def test_model_flops_equal_with_head_fused_or_not():
    """48x96, maxdisp 48, fp32: the fused head's formula counts its last_3
    conv as aten.convolution counts it unfused."""
    rng = np.random.RandomState(0)
    left, right = (torch.from_numpy(rng.randn(1, 48, 96, 3).astype(np.float32)) for _ in range(2))
    counts = {}
    for fused in (True, False):
        cfg = LEAStereoConfig(maxdisp=48, compute_dtype="float32", pallas_head=fused)
        model = best_sceneflow_model(cfg, device="cpu")
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(left, right)
        counts[fused] = counter.get_total_flops()
        if fused:
            ops = {str(op) for op in counter.get_flop_counts()["Global"]}
            assert "leastereo.conv_soft_argmin" in ops
    assert counts[True] == counts[False] == 2_468_577_280
