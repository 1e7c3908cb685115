"""The port's disparity heads (leastereo_tpu_torch/ops/fused_head.py,
fused_softargmin.py) against the JAX Pallas kernels they replace.

On the CPU the wrappers run their plain versions; those are held against
``conv_soft_argmin_pallas`` / ``soft_argmin_pallas`` in interpret mode, on the
same numpy-seeded inputs. The CUDA kernels themselves are held against the
plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leastereo_tpu.ops.packed3d import pack
from leastereo_tpu.ops.pallas_head import conv_soft_argmin_pallas
from leastereo_tpu.ops.pallas_softargmin import soft_argmin_pallas
from leastereo_tpu_torch.ops.fused_head import (
    conv_soft_argmin_cuda,
    conv_soft_argmin_fused,
    conv_soft_argmin_reference,
    fused_head_gate_reason,
)
from leastereo_tpu_torch.ops.fused_softargmin import (
    band_gate_reason,
    soft_argmin_cuda,
    soft_argmin_fused,
)
from leastereo_tpu_torch.ops.softargmin import soft_argmin

# Shapes of tests/test_pallas_head.py: (b, d, h, w, c, g) with g*c = 128.
HEAD_SHAPES = [(1, 8, 16, 24, 32, 4), (2, 16, 16, 16, 16, 8), (1, 16, 24, 48, 32, 4)]
BAND_SHAPES = [(1, 8, 16, 24), (2, 8, 32, 20), (1, 16, 24, 36)]


def _head_inputs(b, d, h, w, c, seed=0):
    """NDHWC volume and DHWIO kernel as the JAX test makes them."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, d, h, w, c) * 0.5).astype(np.float32)
    k = (rng.randn(3, 3, 3, c, 1) * 0.2).astype(np.float32)
    return x, k


def _to_port(x, k):
    """NDHWC -> NCDHW volume, DHWIO -> OIDHW kernel."""
    return (
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))),
        torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2))),
    )


def _peaky_cost(b, d, h, w, seed=0):
    """Trained-like unimodal costs plus noise (tests/test_pallas_softargmin.py)."""
    rng = np.random.RandomState(seed)
    best = rng.randint(0, d, size=(b, 1, h, w))
    planes = np.arange(d)[None, :, None, None]
    return (0.35 * np.abs(planes - best) + 0.8 * rng.randn(b, d, h, w)).astype(np.float32)


@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_plain_matches_pallas(shape):
    b, d, h, w, c, g = shape
    x, k = _head_inputs(b, d, h, w, c)
    ref = np.asarray(conv_soft_argmin_pallas(pack(jnp.asarray(x), g).data, jnp.asarray(k), g, c, 3 * d, True))
    vol, kern = _to_port(x, k)
    got = conv_soft_argmin_reference(vol, kern, 3 * d).numpy()
    assert got.shape == (b, 3 * h, 3 * w)
    # fp32 on both sides; the conv sums in another order: 2e-3 px.
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_head_edge_clamp_matches_pallas():
    # Constant cost per disparity plane: the border pixels exercise the
    # conv's zero padding and the upsample's edge replication together.
    b, d, h, w, c, g = HEAD_SHAPES[0]
    rng = np.random.RandomState(1)
    x = np.ascontiguousarray(np.broadcast_to(rng.randn(1, d, 1, 1, c), (b, d, h, w, c))).astype(np.float32)
    k = (rng.randn(3, 3, 3, c, 1) * 0.2).astype(np.float32)
    ref = np.asarray(conv_soft_argmin_pallas(pack(jnp.asarray(x), g).data, jnp.asarray(k), g, c, 3 * d, True))
    vol, kern = _to_port(x, k)
    np.testing.assert_allclose(conv_soft_argmin_reference(vol, kern, 3 * d).numpy(), ref, atol=2e-3)


@pytest.mark.parametrize("shape", BAND_SHAPES)
def test_band_plain_matches_pallas(shape):
    b, d, h, w = shape
    cost = _peaky_cost(b, d, h, w)
    ref = np.asarray(soft_argmin_pallas(jnp.asarray(cost), 3 * d, True))
    got = soft_argmin(torch.from_numpy(cost), 3 * d).numpy()
    assert got.shape == (b, 3 * h, 3 * w)
    # Same math up to fp32 reassociation: 1e-3 px.
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_flat_cost_gives_center_expectation():
    b, d, h, w = 1, 8, 16, 16
    out = soft_argmin_cuda(torch.zeros(b, d, h, w), 3 * d).numpy()
    # Uniform distribution over 3d disparities -> expectation (3d-1)/2.
    np.testing.assert_allclose(out, (3 * d - 1) / 2.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(soft_argmin_pallas(jnp.zeros((b, d, h, w)), 3 * d, True)), out, atol=1e-4)


def test_cpu_wrappers_take_plain_versions():
    b, d, h, w, c, _ = HEAD_SHAPES[0]
    x, k = _head_inputs(b, d, h, w, c, seed=3)
    vol, kern = _to_port(x, k)
    cost = torch.from_numpy(_peaky_cost(b, d, h, w, seed=3))
    before = (conv_soft_argmin_cuda.launches, soft_argmin_cuda.launches)
    assert torch.equal(conv_soft_argmin_cuda(vol, kern, 3 * d), conv_soft_argmin_reference(vol, kern, 3 * d))
    assert torch.equal(soft_argmin_cuda(cost, 3 * d), soft_argmin(cost, 3 * d))
    assert (conv_soft_argmin_cuda.launches, soft_argmin_cuda.launches) == before


def test_autograd_functions_match_plain_gradients():
    b, d, h, w, c = 1, 8, 12, 12, 8
    x, k = _head_inputs(b, d, h, w, c, seed=4)
    vol, kern = _to_port(x, k)

    def grads(fn, *args):
        args = [a.clone().requires_grad_(True) for a in args]
        (fn(*args) ** 2).sum().backward()
        return [a.grad for a in args]

    for got, ref in zip(
        grads(lambda v, q: conv_soft_argmin_fused(v, q, 3 * d), vol, kern),
        grads(lambda v, q: conv_soft_argmin_reference(v, q, 3 * d), vol, kern),
    ):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    cost = torch.from_numpy(_peaky_cost(b, d, h, w, seed=4))
    (g_fused,) = grads(lambda q: soft_argmin_fused(q, 3 * d), cost)
    (g_ref,) = grads(lambda q: soft_argmin(q, 3 * d), cost)
    torch.testing.assert_close(g_fused, g_ref, atol=1e-5, rtol=1e-5)


def test_gates():
    # KITTI, maxdisp 192: D = 64, C = 32, bf16 and fp32.
    assert fused_head_gate_reason(32, 64, 192, torch.bfloat16) is None
    assert fused_head_gate_reason(32, 64, 192, torch.float32) is None
    assert "maxdisp" in fused_head_gate_reason(32, 64, 190, torch.bfloat16)
    assert "dtype" in fused_head_gate_reason(32, 64, 192, torch.float16)
    # Middlebury, maxdisp 408: D = 136 exceeds the fused head's shared memory
    # but fits the band kernel's tile.
    assert "shared memory" in fused_head_gate_reason(32, 136, 408, torch.bfloat16)
    assert band_gate_reason(136, 408) is None
    assert band_gate_reason(170, 510) is None
    assert "shared memory" in band_gate_reason(171, 513)
    assert "maxdisp" in band_gate_reason(64, 191)


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        soft_argmin_cuda(torch.zeros(1, 8, 4), 24)
    with pytest.raises(ValueError):
        conv_soft_argmin_cuda(torch.zeros(1, 4, 8, 4, 4), torch.zeros(1, 3, 3, 3, 3), 24)
    with pytest.raises(ValueError, match="maxdisp"):
        soft_argmin_cuda(torch.zeros(1, 8, 4, 4), 25)
