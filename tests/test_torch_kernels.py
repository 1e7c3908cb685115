"""The port's disparity heads (leastereo_tpu_torch/ops/fused_head.py,
fused_softargmin.py) against the JAX Pallas kernels they replace.

On the CPU the wrappers run their plain versions; those are held against
``conv_soft_argmin_pallas`` / ``soft_argmin_pallas`` in interpret mode, on the
same numpy-seeded inputs. The sm90 fused head's decomposition (tensor-core
channel contraction per voxel, then the 27-tap sum at clamped tile sites) is
replayed here in plain torch, tile by tile, and held against the same JAX
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
    conv_soft_argmin_simt,
    conv_soft_argmin_sm90,
    fused_head_gate_reason,
    fused_head_route,
    fused_head_sm90_gate_reason,
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
    counters = (conv_soft_argmin_simt, conv_soft_argmin_sm90, soft_argmin_cuda)
    before = [f.launches for f in counters]
    ref = conv_soft_argmin_reference(vol, kern, 3 * d)
    for fn in (conv_soft_argmin_cuda, conv_soft_argmin_simt, conv_soft_argmin_sm90):
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
    assert fused_head_gate_reason(32, 64, 192, torch.bfloat16) is None
    assert fused_head_gate_reason(32, 64, 192, torch.float32) is None
    assert "maxdisp" in fused_head_gate_reason(32, 64, 190, torch.bfloat16)
    assert "dtype" in fused_head_gate_reason(32, 64, 192, torch.float16)
    # Middlebury, maxdisp 408: D = 136 exceeds the fused head's shared memory
    # but fits the band kernel's tile.
    assert "shared memory" in fused_head_gate_reason(32, 136, 408, torch.bfloat16)
    assert band_gate_reason(136, 408) is None
    assert band_gate_reason(170, 510) is None
    # The band kernel's 1 x 32 tile: 408 B a plane, D <= 569.
    assert band_gate_reason(569, 1707) is None
    assert "shared memory" in band_gate_reason(570, 1710)
    assert "maxdisp" in band_gate_reason(64, 191)
    # The sm90 kernel: bf16, C a multiple of 16 up to 64, w a multiple of 8.
    assert fused_head_sm90_gate_reason(32, 64, 416, 192, torch.bfloat16) is None
    assert "dtype" in fused_head_sm90_gate_reason(32, 64, 416, 192, torch.float32)
    assert "C=24" in fused_head_sm90_gate_reason(24, 64, 416, 192, torch.bfloat16)
    assert "C=80" in fused_head_sm90_gate_reason(80, 8, 416, 24, torch.bfloat16)
    assert "w=412" in fused_head_sm90_gate_reason(32, 64, 412, 192, torch.bfloat16)
    assert "maxdisp" in fused_head_sm90_gate_reason(32, 64, 416, 190, torch.bfloat16)
    # Its smaller tile takes Middlebury's D = 136 at bf16, which the first design refuses.
    assert fused_head_sm90_gate_reason(32, 136, 504, 408, torch.bfloat16) is None
    assert "shared memory" in fused_head_sm90_gate_reason(32, 300, 504, 900, torch.bfloat16)
    # Routing: KITTI bf16 -> sm90; fp32 and the shapes sm90 refuses -> the first design.
    assert fused_head_route(32, 64, 416, 192, torch.bfloat16) == "sm90"
    assert fused_head_route(32, 64, 416, 192, torch.float32) == "simt"
    assert fused_head_route(24, 64, 416, 192, torch.bfloat16) == "simt"
    assert fused_head_route(32, 64, 412, 192, torch.bfloat16) == "simt"
    assert fused_head_route(32, 136, 504, 408, torch.bfloat16) == "sm90"
    assert fused_head_route(32, 136, 504, 408, torch.float32) is None
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


def _sm90_cost_tiles(vol: torch.Tensor, kern: torch.Tensor) -> dict:
    """The sm90 kernel's cost tiles [D][TH+2][TW+2], in plain fp32 torch: per
    block, P[voxel, tap] = V . (W0 + W1 + W2) over channels (the tensor-core
    contraction, one product per bf16 weight part), then at each tile site the
    9 (kh, kw) taps of each kd, summed at its clamped in-frame site, added into
    cost plane d_in - kd + 1."""
    th, tw, sr, sw = SM90_TH, SM90_TW, SM90_TH + 4, SM90_TW + 4
    b, c, d, h, w = vol.shape
    parts = _bf16_parts(kern.reshape(c, 27), 3)
    pad = (8, 32, 2, sr)  # zero fill: what TMA reads outside the frame
    vpad = F.pad(vol, pad)
    tiles = {}
    for bi in range(b):
        for i0 in range(0, h, th):
            for j0 in range(-SM90_SHIFT, w, tw):
                box = vpad[bi, :, :, i0 - 2 + pad[2] : i0 - 2 + pad[2] + sr, j0 - 2 + pad[0] : j0 - 2 + pad[0] + sw]
                p = sum(torch.einsum("cdyx,ct->dtyx", box, part) for part in parts).reshape(d, 27, sr * sw)
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


@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_sm90_arithmetic_matches_pallas(shape):
    b, d, h, w, c, g = shape
    x, k = _head_inputs(b, d, h, w, c, seed=5)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # the kernel reads a bf16 volume
    ref = np.asarray(conv_soft_argmin_pallas(pack(jnp.asarray(x), g).data, jnp.asarray(k), g, c, 3 * d, True))
    vol, kern = _to_port(x, k)
    tiles = _sm90_cost_tiles(vol, kern)
    cost = torch.empty(b, d, h, w)
    for (bi, i0, j0), t in tiles.items():
        lo = max(j0, 0)
        cost[bi, :, i0 : i0 + SM90_TH, lo : j0 + SM90_TW] = t[:, 1 : 1 + min(SM90_TH, h - i0), 1 + lo - j0 : 1 + min(SM90_TW, w - j0)]
    # Each tile's halo and out-of-frame sites hold the cost of the clamped site.
    for (bi, i0, j0), t in tiles.items():
        ri = (i0 - 1 + torch.arange(SM90_TH + 2)).clamp(0, h - 1)
        rj = (j0 - 1 + torch.arange(SM90_TW + 2)).clamp(0, w - 1)
        torch.testing.assert_close(t, cost[bi][:, ri][:, :, rj], atol=1e-5, rtol=1e-5)
    got = soft_argmin(cost, 3 * d).numpy()
    # fp32 on both sides, the conv summed in another order: 2e-3 px.
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


# Geometry of the shared stage (csrc/heads_common.cuh) in each kernel that
# runs it: (tile rows, tile cols, threads, column shift of the first tile).
STAGE_GEOMETRY = {"band": (1, 32, 96, 0), "head": (8, 32, 512, 0), "sm90": (SM90_TH, SM90_TW, 256, SM90_SHIFT)}
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
