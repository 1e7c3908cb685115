"""The port's disparity heads (leastereo_tpu_torch/ops/fused_head.py,
fused_softargmin.py) against the JAX Pallas kernels they replace.

On the CPU the wrappers run their plain versions; those are held against
``conv_soft_argmin_pallas`` / ``soft_argmin_pallas`` in interpret mode, on the
same numpy-seeded inputs. The sm90 fused heads' decomposition (tensor-core
channel contraction per voxel, then the 27-tap sum at clamped tile sites) is
replayed here in plain torch, tile by tile, for the bf16 kernel's weight
split and the fp32 kernel's 3xTF32 split, and held against the same JAX
kernel. The CUDA kernels themselves are held against the plain versions on
the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leastereo_tpu.ops.packed3d import pack
from leastereo_tpu.ops.pallas_head import conv_soft_argmin_pallas
from leastereo_tpu.ops.pallas_softargmin import soft_argmin_pallas
from leastereo_tpu_torch.ops.fused_head import (
    conv_soft_argmin_cuda,
    conv_soft_argmin_fused,
    conv_soft_argmin_reference,
    conv_soft_argmin_sm90,
    conv_soft_argmin_sm90_repitch,
    conv_soft_argmin_sm90_f32,
    conv_soft_argmin_sm90_f32_repitch,
    fused_head_route,
    fused_head_sm90_gate_reason,
)
from leastereo_tpu_torch.ops import _build
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
    heads = (conv_soft_argmin_sm90, conv_soft_argmin_sm90_f32, conv_soft_argmin_sm90_repitch,
             conv_soft_argmin_sm90_f32_repitch)
    counters = (*heads, soft_argmin_cuda)
    before = [f.launches for f in counters]
    ref = conv_soft_argmin_reference(vol, kern, 3 * d)
    for fn in (conv_soft_argmin_cuda, *heads):
        assert torch.equal(fn(vol, kern, 3 * d), ref)
        # A bf16 volume the sm90 gate admits takes the plain version too.
        assert torch.equal(fn(vol.bfloat16(), kern, 3 * d), conv_soft_argmin_reference(vol.bfloat16(), kern, 3 * d))
    assert torch.equal(soft_argmin_cuda(cost, 3 * d), soft_argmin(cost, 3 * d))
    assert [f.launches for f in counters] == before


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
    assert fused_head_sm90_gate_reason(32, 64, 192, torch.bfloat16) is None
    assert fused_head_sm90_gate_reason(32, 64, 192, torch.float32) is None
    assert "maxdisp" in fused_head_sm90_gate_reason(32, 64, 190, torch.bfloat16)
    assert "dtype" in fused_head_sm90_gate_reason(32, 64, 192, torch.float16)
    # Middlebury, maxdisp 408: D = 136 fits the fused head's shared memory
    # and the band kernel's tile; D = 300 only the band kernel's.
    assert fused_head_sm90_gate_reason(32, 136, 408, torch.bfloat16) is None
    assert "shared memory" in fused_head_sm90_gate_reason(32, 300, 900, torch.bfloat16)
    assert band_gate_reason(300, 900) is None
    assert band_gate_reason(136, 408) is None
    assert band_gate_reason(170, 510) is None
    # The band kernel's 1 x 32 tile: 408 B a plane, D <= 569.
    assert band_gate_reason(569, 1707) is None
    assert "shared memory" in band_gate_reason(570, 1710)
    assert "maxdisp" in band_gate_reason(64, 191)
    # The sm90 gate: bf16 or fp32, any C (padded to a multiple of 16 up to
    # 64, 32-channel groups above), any w (the route follows it).
    assert fused_head_sm90_gate_reason(24, 64, 192, torch.bfloat16) is None
    assert fused_head_sm90_gate_reason(80, 8, 24, torch.bfloat16) is None
    assert "maxdisp" in fused_head_sm90_gate_reason(32, 64, 190, torch.bfloat16)
    # Routing: KITTI bf16 -> sm90, fp32 -> the fp32 sm90 kernel, both by TMA;
    # C = 24 in place with padded channels; w = 412 bf16 (not a multiple of
    # 8) copied to rows of whole 16-byte lines first, as is an unaligned base.
    assert fused_head_route(32, 64, 416, 192, torch.bfloat16) == "sm90"
    assert fused_head_route(32, 64, 416, 192, torch.float32) == "sm90_f32"
    assert fused_head_route(24, 64, 416, 192, torch.bfloat16) == "sm90"
    assert fused_head_route(32, 64, 412, 192, torch.bfloat16) == "sm90_repitch"
    assert fused_head_route(32, 64, 416, 192, torch.bfloat16, aligned=False) == "sm90_repitch"
    assert fused_head_route(32, 136, 504, 408, torch.bfloat16) == "sm90"
    # Middlebury fp32: the fp32 kernel's two-stage ring fits.
    assert fused_head_route(32, 136, 504, 408, torch.float32) == "sm90_f32"
    assert fused_head_route(32, 64, 416, 190, torch.bfloat16) is None


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        soft_argmin_cuda(torch.zeros(1, 8, 4), 24)
    with pytest.raises(ValueError):
        conv_soft_argmin_cuda(torch.zeros(1, 4, 8, 4, 4), torch.zeros(1, 3, 3, 3, 3), 24)
    with pytest.raises(ValueError, match="maxdisp"):
        soft_argmin_cuda(torch.zeros(1, 8, 4, 4), 25)


# Geometry of csrc/fused_head_sm90.cu: 8 x 16 tiles starting at j = 16 k - 6,
# each reading voxels (i0 - 2.., j0 - 2..) of (TH + 4) x (TW + 4).
SM90_TH, SM90_TW, SM90_SHIFT = 8, 16, 6


def _bf16_parts(w: torch.Tensor, n: int) -> list[torch.Tensor]:
    """Split fp32 weights into ``n`` bf16 parts (each returned in fp32), as
    the sm90 kernel does: part p = bf16(w - parts before it)."""
    parts, rest = [], w.clone()
    for _ in range(n):
        part = rest.to(torch.bfloat16).to(torch.float32)
        parts.append(part)
        rest = rest - part
    return parts


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
    from zero; the low 13 mantissa bits zero), returned in fp32."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_parts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 sm90 kernel's split of a voxel or weight: big = tf32(x),
    small = tf32(x - big)."""
    big = _tf32(x)
    return big, _tf32(x - big)


def _sm90_products(vol: torch.Tensor, kern: torch.Tensor) -> list:
    """(volume part, weight part (C, 27)) of each tensor-core product the
    sm90 kernel of ``vol``'s dtype accumulates: bf16 (the volume as given,
    rounded by the caller), the three bf16 weight parts; fp32, 3xTF32
    small(V) big(W), big(V) small(W), big(V) big(W)."""
    w = kern.reshape(kern.shape[1], 27)
    if vol.dtype == torch.bfloat16:
        return [(vol.float(), part) for part in _bf16_parts(w, 3)]
    (vb, vs), (wb, ws) = _tf32_parts(vol), _tf32_parts(w)
    return [(vs, wb), (vb, ws), (vb, wb)]


def _sm90_cost_tiles(vol: torch.Tensor, kern: torch.Tensor) -> dict:
    """The sm90 kernel's cost tiles [D][TH+2][TW+2], in plain fp32 torch: per
    block, P[voxel, tap] = sum of the products of :func:`_sm90_products` over
    channels (the tensor-core contraction), accumulated ring entry by ring
    entry (the channels zero-padded to a whole number of entries of
    ``_build.head_sm90_entry_channels(C)``), then at each tile site the 9
    (kh, kw) taps of each kd, summed at its clamped in-frame site, added into
    cost plane d_in - kd + 1."""
    th, tw, sr, sw = SM90_TH, SM90_TW, SM90_TH + 4, SM90_TW + 4
    b, c, d, h, w = vol.shape
    entry = _build.head_sm90_entry_channels(c)
    cp = -(-c // entry) * entry
    vol = F.pad(vol, (0, 0, 0, 0, 0, 0, 0, cp - c))  # padded channels read as zero
    kern = F.pad(kern, (0, 0, 0, 0, 0, 0, 0, cp - c))  # and have zero weights
    pad = (8, 32, 2, sr)  # zero fill: what TMA reads outside the frame
    products = [(F.pad(v, pad), part) for v, part in _sm90_products(vol, kern)]
    tiles = {}
    for bi in range(b):
        for i0 in range(0, h, th):
            for j0 in range(-SM90_SHIFT, w, tw):
                rows = slice(i0 - 2 + pad[2], i0 - 2 + pad[2] + sr)
                cols = slice(j0 - 2 + pad[0], j0 - 2 + pad[0] + sw)
                p = 0
                for e in range(0, cp, entry):  # P += each entry's products
                    p = p + sum(torch.einsum("cdyx,ct->dtyx", v[bi, e : e + entry, :, rows, cols], part[e : e + entry])
                                for v, part in products)
                p = p.reshape(d, 27, sr * sw)
                gi = (i0 - 1 + torch.arange(th + 2)).clamp(0, h - 1) - (i0 - 2)
                gj = (j0 - 1 + torch.arange(tw + 2)).clamp(0, w - 1) - (j0 - 2)
                pc = ((gi[:, None] - 1) * sw + (gj[None, :] - 1)).reshape(-1)
                q = torch.zeros(d + 2, 3, pc.numel())  # input planes -1..D, taps summed per kd
                for kd in range(3):
                    for kh in range(3):
                        for kw in range(3):
                            q[1 : d + 1, kd] += p[:, kd * 9 + kh * 3 + kw, pc + kh * sw + kw]
                # cost plane e takes kd = 0 of input plane e - 1, kd = 1 of e, kd = 2 of e + 1.
                cost = q[0:d, 0] + q[1 : d + 1, 1] + q[2 : d + 2, 2]
                tiles[bi, i0, j0] = cost.reshape(d, th + 2, tw + 2)
    return tiles


def _sm90_replay(vol: torch.Tensor, kern: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """The sm90 kernel's output replayed from :func:`_sm90_cost_tiles`: each
    tile's interior written into the cost, whose halo and out-of-frame
    sites must hold the cost of the clamped site, then the softmin."""
    b, _, d, h, w = vol.shape
    tiles = _sm90_cost_tiles(vol, kern)
    cost = torch.empty(b, d, h, w)
    for (bi, i0, j0), t in tiles.items():
        lo = max(j0, 0)
        cost[bi, :, i0 : i0 + SM90_TH, lo : j0 + SM90_TW] = t[:, 1 : 1 + min(SM90_TH, h - i0), 1 + lo - j0 : 1 + min(SM90_TW, w - j0)]
    for (bi, i0, j0), t in tiles.items():
        ri = (i0 - 1 + torch.arange(SM90_TH + 2)).clamp(0, h - 1)
        rj = (j0 - 1 + torch.arange(SM90_TW + 2)).clamp(0, w - 1)
        torch.testing.assert_close(t, cost[bi][:, ri][:, :, rj], atol=1e-5, rtol=1e-5)
    return soft_argmin(cost, maxdisp)


@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_sm90_arithmetic_matches_pallas(shape):
    b, d, h, w, c, g = shape
    x, k = _head_inputs(b, d, h, w, c, seed=5)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # the kernel reads a bf16 volume
    ref = np.asarray(conv_soft_argmin_pallas(pack(jnp.asarray(x), g).data, jnp.asarray(k), g, c, 3 * d, True))
    vol, kern = _to_port(x, k)
    got = _sm90_replay(vol.bfloat16(), kern, 3 * d).numpy()
    # fp32 on both sides, the conv summed in another order: 2e-3 px.
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_sm90_f32_arithmetic_matches_pallas(shape):
    """The fp32 kernel's decomposition with its 3xTF32 contraction, on an
    fp32 volume, against the JAX kernel in fp32."""
    b, d, h, w, c, g = shape
    x, k = _head_inputs(b, d, h, w, c, seed=8)
    ref = np.asarray(conv_soft_argmin_pallas(pack(jnp.asarray(x), g).data, jnp.asarray(k), g, c, 3 * d, True))
    vol, kern = _to_port(x, k)
    got = _sm90_replay(vol, kern, 3 * d).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)


# (b, d, h, w, c, g): channels the sm90 heads pad (24 -> 32 and 12 -> 16) or
# group (80: two 32-channel entries and a 16-channel one padded to 32); g
# packs them for the JAX kernel (g * C a multiple of 128).
ENTRY_SHAPES = [(1, 16, 16, 24, 24, 16), (1, 32, 16, 16, 12, 32), (1, 8, 16, 24, 80, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ENTRY_SHAPES)
def test_sm90_padded_and_grouped_arithmetic_matches_pallas(shape, dtype):
    """The decomposition at padded and grouped C (zero channels, P summed
    entry by entry), for each volume type's contraction, against the JAX
    kernel on the same values."""
    b, d, h, w, c, g = shape
    x, k = _head_inputs(b, d, h, w, c, seed=11)
    x = torch.from_numpy(x).to(dtype).float().numpy()
    ref = np.asarray(conv_soft_argmin_pallas(pack(jnp.asarray(x), g).data, jnp.asarray(k), g, c, 3 * d, True))
    vol, kern = _to_port(x, k)
    got = _sm90_replay(vol.to(dtype), kern, 3 * d).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_weight_split_keeps_fp32_weights():
    rng = np.random.RandomState(6)
    w = torch.from_numpy((rng.randn(4096) * np.exp(rng.uniform(-8, 4, 4096))).astype(np.float32))
    hi, lo = _bf16_parts(w, 2)
    assert ((hi + lo - w).abs() <= 2.0**-16 * w.abs()).all()
    # The kernel's three parts reproduce every weight exactly.
    assert torch.equal(sum(_bf16_parts(w, 3)), w)
    # bf16 weights (the main path's) have zero second and third parts.
    assert all(torch.equal(p, torch.zeros_like(p)) for p in _bf16_parts(w.bfloat16().float(), 3)[1:])


def test_tf32_split_keeps_fp32_values():
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.randn(4096) * np.exp(rng.uniform(-8, 4, 4096))).astype(np.float32))
    big, small = _tf32_parts(x)
    # Both parts are tf32 values: 10 explicit mantissa bits, the low 13 zero.
    for part in (big, small):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    # big is x rounded to nearest (half an ulp of 11 bits), x - big is exact,
    # and big + small keeps x to 2^-22.
    assert ((x - big).abs() <= 2.0**-11 * x.abs()).all()
    assert ((big + small - x).abs() <= 2.0**-22 * x.abs()).all()
    # Ties go away from zero, as cvt.rna does: 1 + 2^-11 lies halfway.
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)])
    assert torch.equal(_tf32(tie), torch.tensor([1.0 + 2.0**-10, -(1.0 + 2.0**-10)]))


# The fp32 sm90 head's gate and route, the ring depth and the shared memory
# by csrc/fused_head_sm90.cu's layout: a stage of 4 C 20 (8 + 4) B plus two
# 8 B mbarriers (one a channel half); P 4 x 27 x 244 = 26,352 B; the cost tile 4 D 10 x 18 B; up to
# two stages, as many as fit in 115,712 B (two blocks an SM) for C <= 32 when
# one does, else in 232,448 B. (C, D, w, maxdisp), expected stages, bytes,
# route, and the refusal's words.
F32_GATE_CASES = {
    "kitti_416x128": ((32, 64, 416, 192), 1, 30736 + 26352 + 46080, "sm90_f32", None),
    "finetune_val_192": ((32, 64, 192, 192), 1, 30736 + 26352 + 46080, "sm90_f32", None),
    "export_96x192": ((32, 16, 64, 48), 2, 2 * 30736 + 26352 + 11520, "sm90_f32", None),
    "middlebury_d136": ((32, 136, 504, 408), 2, 2 * 30736 + 26352 + 97920, "sm90_f32", None),
    "w_not_multiple_of_4": ((32, 64, 414, 192), 1, 30736 + 26352 + 46080, "sm90_f32_repitch", None),
    "c16": ((16, 64, 416, 192), 2, 2 * 15376 + 26352 + 46080, "sm90_f32", None),
    "c24": ((24, 64, 416, 192), 1, 30736 + 26352 + 46080, "sm90_f32", None),
    "c64": ((64, 64, 416, 192), 2, 2 * 61456 + 26352 + 46080, "sm90_f32", None),
    "c64_d136": ((64, 136, 504, 408), 1, 61456 + 26352 + 97920, "sm90_f32", None),
    "c32_d569": ((32, 569, 504, 1707), 0, 30736 + 26352 + 409680, None, "shared memory"),
}


@pytest.mark.parametrize("case", list(F32_GATE_CASES))
def test_sm90_f32_gate_and_route(case):
    (c, d, w, maxdisp), stages, smem, route, refusal = F32_GATE_CASES[case]
    assert _build.head_sm90_f32_stages(c, d) == stages
    if smem is not None:
        assert _build.head_sm90_f32_smem_bytes(c, d) == smem
        assert (smem <= _build.SMEM_LIMIT) == (stages >= 1)
        # Two blocks an SM exactly where the layout fits in half an SM.
        assert (smem <= _build.SMEM_PAIR_LIMIT) == (c <= 32 and d <= 64)
    reason = fused_head_sm90_gate_reason(c, d, maxdisp, torch.float32)
    assert (reason is None) == (refusal is None), reason
    if refusal is not None:
        assert refusal in reason
    assert fused_head_route(c, d, w, maxdisp, torch.float32) == route
    # The bf16 kernel's layout is its own (two bf16 stages).
    assert _build.head_sm90_smem_bytes(32, 64) == 2 * (2 * 32 * 312 + 8) + 26352 + 46080


def _head_inputs_kind(kind, b, c, d, h, w, seed=0):
    """chip_smoke.py's ``head_inputs`` in numpy: "peaky" (channel 0 a
    trained-like cost the kernel's centre tap passes), "wide" (its kernel
    10x) or "diffuse" (random volume and kernel)."""
    rng = np.random.RandomState(seed)
    vol = (0.5 * rng.randn(b, c, d, h, w)).astype(np.float32)
    if kind == "diffuse":
        kern = 0.2 * rng.randn(1, c, 3, 3, 3)
    else:
        vol[:, 0] = _peaky_cost(b, d, h, w, seed=seed + 1)
        kern = 0.02 * rng.randn(1, c, 3, 3, 3)
        kern[0, 0, 1, 1, 1] += 1.0
        kern *= 10.0 if kind == "wide" else 1.0
    return torch.from_numpy(vol), torch.from_numpy(kern.astype(np.float32))


@pytest.mark.parametrize("kind", ["peaky", "wide", "diffuse"])
def test_sm90_f32_split_numerics_hold_fp32(kind):
    """The fp32 kernel's 3xTF32 arithmetic, emulated with parts rounded bit
    for bit (products of tf32 values are exact in fp32), through the plain
    head at 48x96, maxdisp 48, C = 32: within 2e-3 px of float64. One tf32
    part alone (the single-pass TF32 contraction, as cuDNN's TF32 would run
    it) misses that on the wide and diffuse inputs: the split is needed."""
    vol, kern = _head_inputs_kind(kind, 1, 32, 16, 16, 32, seed=10)
    ref = conv_soft_argmin_reference(vol.double(), kern.double(), 48)
    (vb, vs), (wb, ws) = _tf32_parts(vol), _tf32_parts(kern)

    def head(pairs):
        cost = sum(F.conv3d(v, k, padding=1) for v, k in pairs)[:, 0]
        return (soft_argmin(cost, 48).double() - ref).abs().max().item()

    assert head([(vs, wb), (vb, ws), (vb, wb)]) < 2e-3
    if kind != "peaky":
        assert head([(vb, wb)]) > 2e-3


# Geometry of the shared stage (csrc/heads_common.cuh) in each kernel that
# runs it: (tile rows, tile cols, threads, column shift of the first tile).
STAGE_GEOMETRY = {"band": (1, 32, 96, 0), "sm90": (SM90_TH, SM90_TW, 256, SM90_SHIFT)}
# (shape, cost scale): the band shapes, a wide-span cost and D = 13.
STAGE_CASES = [(s, 1.0) for s in BAND_SHAPES] + [((1, 8, 16, 24), 300.0), ((1, 13, 16, 24), 1.0)]


def _stage_phases(cost: torch.Tensor) -> torch.Tensor:
    """The stage's arithmetic in plain fp32 torch, ``(B, D, h, w)`` ->
    ``(B, 3, 3, h, w)`` (rh, rw phases): c_k blended H then W from the
    edge-replicated cost, pass 1 m = min_k c_k, pass 2 one exponential
    u_k = 2^((m - c_k) log2(e) / 3) per plane and phase, and the three
    disparity phases as the products u_{k-1} u_k^2, u_k^3, u_k^2 u_{k+1}."""
    b, d, h, w = cost.shape
    x = F.pad(cost, (1, 1, 1, 1), mode="replicate")
    third, two_third = torch.tensor(1.0 / 3.0), torch.tensor(2.0 / 3.0)
    rows = [third * x[:, :, 0:h] + two_third * x[:, :, 1 : h + 1], x[:, :, 1 : h + 1],
            two_third * x[:, :, 1 : h + 1] + third * x[:, :, 2 : h + 2]]
    c = torch.stack([torch.stack([third * r[..., 0:w] + two_third * r[..., 1 : w + 1], r[..., 1 : w + 1],
                                  two_third * r[..., 1 : w + 1] + third * r[..., 2 : w + 2]], dim=2)
                     for r in rows], dim=2)  # (B, D, rh, rw, h, w)
    m = c.amin(dim=1, keepdim=True)
    u = torch.exp2((m - c) * torch.tensor(1.4426950408889634 / 3.0))
    up = torch.cat([u[:, :1], u[:, :-1]], dim=1)
    un = torch.cat([u[:, 1:], u[:, -1:]], dim=1)
    s, sq = up + u + un, u * u
    i3 = 3.0 * torch.arange(d, dtype=torch.float32).view(1, d, 1, 1, 1, 1)
    return (sq * (i3 * s + u + 2.0 * un)).sum(1) / (sq * s).sum(1)


def _stage_replay(cost: torch.Tensor, th: int, tw: int, nt: int, shift: int) -> torch.Tensor:
    """The stage's output assembled as the kernel's threads write it: tile by
    tile, unit u = thread + r * nt is (row phase u // (th tw), pixel
    u % (th tw)) and stores the 3 column phases of one output row. Every
    output is written exactly once (checked)."""
    b, d, h, w = cost.shape
    phases = _stage_phases(cost)
    out = torch.full((b, 3 * h, 3 * w), float("nan"))
    writes = torch.zeros(b, 3 * h, 3 * w, dtype=torch.int32)
    pix = th * tw
    for i0 in range(0, h, th):
        for j0 in range(-shift, w, tw):
            for r in range(-(-3 * pix // nt)):
                unit = torch.arange(nt) + r * nt
                unit = unit[unit < 3 * pix]
                rh, p = unit // pix, unit % pix
                gi, gj = i0 + p // tw, j0 + p % tw
                keep = (gi < h) & (gj < w) & (gj >= 0)
                rh, gi, gj = rh[keep], gi[keep], gj[keep]
                for k in range(3):
                    out[:, 3 * gi + rh, 3 * gj + k] = phases[:, rh, k, gi, gj]
                    writes[:, 3 * gi + rh, 3 * gj + k] += 1
    assert torch.equal(writes, torch.ones_like(writes))
    return out


@pytest.mark.parametrize("kernel", list(STAGE_GEOMETRY))
@pytest.mark.parametrize("case", STAGE_CASES)
def test_stage_arithmetic_matches_pallas(case, kernel):
    (b, d, h, w), scale = case
    cost = _peaky_cost(b, d, h, w, seed=7) * np.float32(scale)
    ref = np.asarray(soft_argmin_pallas(jnp.asarray(cost), 3 * d, True))
    got = _stage_replay(torch.from_numpy(cost), *STAGE_GEOMETRY[kernel]).numpy()
    assert got.shape == (b, 3 * h, 3 * w)
    # fp32 on both sides, exp2 of a third of the exponent and products in
    # place of three exponentials: 1e-3 px, as test_band_plain_matches_pallas.
    np.testing.assert_allclose(got, ref, atol=1e-3)
