"""The fused head's routes (leastereo_tpu_torch/ops/fused_head.py) on the CPU.

Every volume the first fused head design took now has an sm90 route (the
channels padded or grouped, the volume read in place or first copied into
rows of whole 16-byte lines);
the shared memory of padded and grouped channel counts is that of the
entry's channels; and a model whose matching net is 24 channels wide matches
the JAX model on the same weights and numpy inputs. The kernels themselves
run on the card only (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leastereo_tpu.models import LEAStereoConfig as JaxConfig
from leastereo_tpu.models import best_sceneflow_model as jax_best
from leastereo_tpu.utils.torch_convert import import_torch_state_dict
from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.ops import _build
from leastereo_tpu_torch.ops.fused_head import ROUTES, fused_head_route, fused_head_sm90_gate_reason, repitched
from leastereo_tpu_torch.utils.kernel_parity import offset_copy


def first_design_admits(channels: int, d: int, maxdisp: int, dtype: torch.dtype) -> bool:
    """The retired first fused head design's gate, as it stood: maxdisp = 3 D,
    fp32 or bf16, and its shared memory (cost tile [D][8+2][32+2], one staged
    channel [ceil8(D)+2][8+4][32+4], the weights; fp32) within 232,448 B."""
    if maxdisp != 3 * d or dtype not in (torch.float32, torch.bfloat16):
        return False
    dp = -(-d // 8) * 8
    return 4 * (d * 10 * 34 + (dp + 2) * 12 * 36 + 27 * channels) <= 232448


COVER_C = (1, 8, 12, 16, 24, 40, 64, 80, 128, 290)
COVER_D = (1, 13, 16, 64, 70, 72)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_shape_the_first_design_took_has_an_sm90_route(dtype):
    admitted = 0
    for c, d, r, aligned in itertools.product(COVER_C, COVER_D, range(8), (True, False)):
        w = 408 + r
        if not first_design_admits(c, d, 3 * d, dtype):
            continue
        admitted += 1
        in_place = aligned and w * dtype.itemsize % 16 == 0
        want = ("sm90" if dtype == torch.bfloat16 else "sm90_f32") + ("" if in_place else "_repitch")
        assert fused_head_route(c, d, w, 3 * d, dtype, aligned=aligned) == want, (c, d, w, aligned)
        assert ROUTES[want] == (dtype, in_place)
    # The grid reaches the first design's limits: every C at D <= 64, and
    # C = 290 at D = 64 (its widest), are admitted.
    assert first_design_admits(290, 64, 192, dtype) and not first_design_admits(291, 64, 192, dtype)
    assert admitted == 2 * 8 * (len(COVER_C) * 4 + sum(first_design_admits(c, d, 3 * d, dtype)
                                                        for c in COVER_C for d in (70, 72)))


def test_routes_refuse_only_depth_and_maxdisp():
    # Deeper than the cost tile allows, or maxdisp != 3 D: every route refuses.
    assert fused_head_route(32, 300, 504, 900, torch.bfloat16) is None
    assert "shared memory" in fused_head_sm90_gate_reason(32, 300, 900, torch.bfloat16)
    assert fused_head_route(24, 64, 416, 190, torch.float32) is None
    assert "maxdisp" in fused_head_sm90_gate_reason(24, 64, 190, torch.float32)
    assert "dtype" in fused_head_sm90_gate_reason(24, 64, 192, torch.float16)
    # Channel groups keep the shared memory of C = 32 at any C.
    assert fused_head_route(1000, 64, 416, 192, torch.bfloat16) == "sm90"
    assert fused_head_route(1000, 64, 414, 192, torch.float32) == "sm90_f32_repitch"


# (volume dtype, bytes past a 16-byte boundary): every offset an element allows, up to 8.
REPITCH_CASES = [(torch.bfloat16, o) for o in (0, 2, 4, 8)] + [(torch.float32, o) for o in (0, 4, 8)]


@pytest.mark.parametrize("dtype,offset", REPITCH_CASES)
def test_repitched_copy_is_what_tma_reads(dtype, offset):
    """The repitch routes' copy, at every residue of w mod 8 and at bases off
    a 16-byte boundary: an aligned buffer whose rows are whole 16-byte lines
    and whose first w columns are the volume, bit for bit."""
    es = torch.tensor([], dtype=dtype).element_size()
    rng = np.random.RandomState(offset)
    for w in range(408, 416):
        vol = offset_copy(torch.from_numpy(rng.randn(2, 3, 4, 5, w).astype(np.float32)).to(dtype), offset)
        out, pitch = repitched(vol)
        assert out.shape == (2, 3, 4, 5, pitch) and out.data_ptr() % 16 == 0
        assert w <= pitch < w + 16 // es and pitch * es % 16 == 0
        assert torch.equal(out[..., :w], vol)


# (C, entry channels): padded to a multiple of 16 up to 64, a 32-channel group above.
ENTRY_CASES = [(1, 16), (8, 16), (12, 16), (16, 16), (24, 32), (40, 48), (64, 64), (80, 32), (290, 32)]


@pytest.mark.parametrize("c,entry", ENTRY_CASES)
def test_shared_memory_of_padded_and_grouped_channels(c, entry):
    assert _build.head_sm90_entry_channels(c) == entry
    for d in (1, 13, 64, 136):
        # The layout is that of the entry's channels: bf16 two stages of
        # [entry][13][24] + an mbarrier each, P 26,352 B, the cost tile 720 D B.
        assert _build.head_sm90_smem_bytes(c, d) == 2 * (2 * entry * 312 + 8) + 26352 + 720 * d
        assert _build.head_sm90_f32_stages(c, d) == _build.head_sm90_f32_stages(entry, d)
        assert _build.head_sm90_f32_smem_bytes(c, d) == _build.head_sm90_f32_smem_bytes(entry, d)
    # KITTI's D = 64: two fp32 stages up to 16 channels an entry, one in half
    # an SM at 24 and 32 (two blocks an SM), two in a whole SM from 48.
    stages = _build.head_sm90_f32_stages(c, 64)
    assert stages == {16: 2, 32: 1, 48: 2, 64: 2}[entry]
    assert _build.head_sm90_f32_smem_bytes(c, 64) == stages * (4 * entry * 240 + 16) + 26352 + 46080


# The 24-channel model: the small config at 48x96, maxdisp 48, fp32,
# mat_filter_multiplier 6 (C = 6 x 4 = 24). Its 1/3-resolution w is a
# multiple of 8: the matching net of either package raises on a frame whose
# w is not (48x84 gives w = 28), so a model's volume always takes a TMA
# route that reads it in place, and the repitch routes serve callers of the
# op alone.
H, W, MAXDISP = 48, 96, 48
TOL_PX = 2e-3  # the whole-model bound of tests/test_torch_model.py


def test_24_channel_model_matches_jax():
    cfg = dict(maxdisp=MAXDISP, compute_dtype="float32", mat_filter_multiplier=6)
    rng = np.random.RandomState(0)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    right = rng.randn(1, H, W, 3).astype(np.float32)
    port = best_sceneflow_model(LEAStereoConfig(**cfg), device="cpu", seed=0)
    with torch.no_grad():
        feats = port.feature(torch.from_numpy(np.concatenate([left, right])).permute(0, 3, 1, 2))
        vol = port.matching(feats[:1], feats[1:], MAXDISP // 3)
        port.matching.last_3.conv.weight.mul_(3.0 / port.matching.last_3(vol).std())
    _, c, d, _, w = vol.shape
    assert (c, d, w) == (24, MAXDISP // 3, W // 3)
    # The model takes the fused head: the fp32 TMA route, channels padded to 32.
    assert fused_head_route(c, d, w, MAXDISP, torch.float32) == "sm90_f32"
    assert _build.head_sm90_entry_channels(c) == 32
    sd = port.state_dict()
    jax_model = jax_best(JaxConfig(**cfg))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, import_torch_state_dict(shapes, sd))
    ref = np.asarray(jax.jit(jax_model.apply)(variables, left, right))
    with torch.no_grad():
        got = port(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    assert got.shape == (1, H, W) and np.isfinite(got).all()
    assert ref.std() > 0.5  # the cost is informative, not flat
    assert np.abs(got - ref).max() < TOL_PX
