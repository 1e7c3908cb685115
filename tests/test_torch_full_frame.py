"""The size a ``--full_frame`` run pads a frame to (``LEAStereo.size_multiple``,
``leastereo_tpu_torch/models/leastereo.py``), on the CPU at narrow widths
(filter multiplier 2, maxdisp 48, float32).

(a) For three architectures, the shipped ``BEST_SCENEFLOW``, the tiny net of
``tests/test_cli.py`` and a matching path that reaches level 3, the multiple
is 24, 12 and 48; the port's model runs at H and W of m and 2m and, where the
path leaves a level and comes back to it, raises at 1.5m; and wherever the
JAX drivers' 12-pad lands on a multiple of ``size_multiple``, the port pads
to the same size. The multiple follows the matching net's skips: a searched
path whose skips join cells of two levels has none with them and 12
without them.

(b) A 36x90 frame under a 24x48 crop: the JAX driver pads it to 36x96, which
``BEST_SCENEFLOW``'s matching net refuses (the JAX package's known
behaviour, kept as the reference). The port pads it to 48x96, and its map is
the JAX model's on the same sentinel-padded input, un-padded the same way,
within the whole-model bound of ``tests/test_torch_model.py`` (2e-3 px). The
weights are the port's seeded init with its BN perturbed, carried into the
JAX tree by ``import_torch_state_dict``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leastereo_tpu.cli import predict as jax_predict
from leastereo_tpu.data.transforms import test_transform as jax_test_transform
from leastereo_tpu.models import LEAStereoConfig as JaxConfig
from leastereo_tpu.models import best_sceneflow_model as jax_best
from leastereo_tpu.utils.torch_convert import import_torch_state_dict
from leastereo_tpu_torch import LEAStereoConfig
from leastereo_tpu_torch.cli import predict
from leastereo_tpu_torch.models.genotypes import BEST_SCENEFLOW, Architecture
from leastereo_tpu_torch.models.leastereo import LEAStereo, best_sceneflow_model, size_multiple
from leastereo_tpu_torch.models.matching_net import MatchingNet
from test_torch_model import TOL_PX, _perturbed_state_dict

MAXDISP = 48
NARROW = dict(maxdisp=MAXDISP, fea_filter_multiplier=2, mat_filter_multiplier=2, compute_dtype="float32")

# The decoded tiny net of tests/test_cli.py, and a matching path to level 3.
TINY = (
    Architecture((1, 0), ((0, 1), (1, 0), (3, 1), (2, 1), (8, 1), (5, 0))),
    Architecture((1, 1, 0), ((1, 1), (0, 0), (3, 1), (4, 0), (8, 1), (6, 0))),
)
LEVEL3 = (BEST_SCENEFLOW["feature"], Architecture((1, 2, 3, 3, 2, 1), BEST_SCENEFLOW["matching"].cell_genotype))
NETS = {"best_sceneflow": ((BEST_SCENEFLOW["feature"], BEST_SCENEFLOW["matching"]), 24), "tiny": (TINY, 12),
        "level3": (LEVEL3, 48)}
# The nets whose matching path leaves a level and comes back to it.
RETURNING = ("best_sceneflow", "level3")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread, as ``tests/test_torch_search.py``: a
    pool of one thread a core stalls beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _model(name: str) -> LEAStereo:
    archs, _ = NETS[name]
    return LEAStereo(*archs, LEAStereoConfig(**NARROW), torch.Generator().manual_seed(0)).eval()


def _forward(model, h: int, w: int) -> torch.Tensor:
    x = torch.from_numpy(np.random.RandomState(h * 1000 + w).randn(2, h, w, 3).astype(np.float32))
    with torch.no_grad():
        return model(x[:1], x[1:])


@pytest.mark.parametrize("name", list(NETS))
def test_size_multiple_runs_at_its_multiples(name):
    archs, m = NETS[name]
    model = _model(name)
    assert size_multiple(*archs) == model.size_multiple == m
    for h, w in ((m, 2 * m), (2 * m, m)):
        out = _forward(model, h, w)
        assert out.shape == (1, h, w) and torch.isfinite(out).all()


@pytest.mark.parametrize("axis", ["height", "width"])
@pytest.mark.parametrize("name", RETURNING)
def test_returning_path_raises_between_multiples(name, axis):
    _, m = NETS[name]
    h, w = (m + m // 2, m) if axis == "height" else (m, m + m // 2)
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        _forward(_model(name), h, w)


def test_size_multiple_reads_the_matching_nets_skips():
    """A searched path whose skips join cells of two levels (cells 4 and 8
    here) is taken at no size by the skip net, and at every multiple of 12
    by the non-skip net that serves it (``MatchingNet(skips=())``)."""
    path = Architecture((0, 1, 1, 2, 1, 2, 3, 2, 2, 2, 2, 1), BEST_SCENEFLOW["matching"].cell_genotype)
    model = LEAStereo(BEST_SCENEFLOW["feature"], path, LEAStereoConfig(**NARROW), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="join cells of different levels"):
        model.size_multiple
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        _forward(model.eval(), 48, 96)
    model.matching = MatchingNet(path, 8, 2, 4, 3, skips=(), generator=torch.Generator().manual_seed(0)).eval()
    assert model.size_multiple == size_multiple(BEST_SCENEFLOW["feature"], path, skips=()) == 12
    for h, w in ((12, 24), (36, 60)):
        assert _forward(model, h, w).shape == (1, h, w)


@pytest.mark.parametrize("name", list(NETS))
def test_padding_agrees_with_jax_where_jax_pads_right(name):
    _, m = NETS[name]
    agree = 0
    for h in range(1, 501):
        jax_h = jax_predict.pad_to_valid(h, h)[0]
        port_h = predict.pad_to_valid(h, h, m)[0]
        assert port_h % m == 0 and h <= port_h < h + m
        if jax_h % m == 0:
            assert port_h == jax_h, h
            agree += 1
    assert agree >= 500 * 12 // m - 12  # every m // 12-th step of 12 rows


def test_full_frame_needs_the_models_multiple():
    """``run_frame`` has no multiple of its own to pad a full frame to."""
    stack = np.zeros((8, 30, 60), np.float32)
    with pytest.raises(ValueError, match="size_multiple"):
        predict.run_frame(lambda left, right: None, stack, 24, 48, True, True)


FRAME_H, FRAME_W, CROP_H, CROP_W = 36, 90, 24, 48
PAD_H, PAD_W = 48, 96  # the port's pad; JAX's is 36x96


@pytest.fixture(scope="module")
def weights():
    rng = np.random.RandomState(0)
    port = best_sceneflow_model(LEAStereoConfig(**NARROW), device="cpu")
    sd = _perturbed_state_dict(port, rng)
    x = torch.from_numpy(rng.randn(2, PAD_H, PAD_W, 3).astype(np.float32))
    with torch.no_grad():
        feats = port.feature(x.permute(0, 3, 1, 2))
        cost = port.matching.last_3(port.matching(feats[:1], feats[1:], MAXDISP // 3))
        sd["matching.last_3.conv.weight"].mul_(3.0 / cost.std())
    port.load_state_dict(sd)
    jax_model = jax_best(JaxConfig(**NARROW))
    zeros = jnp.zeros((1, PAD_H, PAD_W, 3))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), zeros, zeros)
    variables = jax.tree_util.tree_map(np.asarray, import_torch_state_dict(shapes, sd))
    stack = rng.randn(8, FRAME_H, FRAME_W).astype(np.float32)
    return port, jax_model, variables, stack


def test_full_frame_matches_jax_model_where_jax_driver_raises(weights):
    port, jax_model, variables, stack = weights
    assert port.size_multiple == 24
    assert jax_predict.pad_to_valid(FRAME_H, FRAME_W) == (36, 96)
    assert predict.pad_to_valid(FRAME_H, FRAME_W, port.size_multiple) == (PAD_H, PAD_W)
    jax_fwd = jax_predict.make_forward(jax_model, variables)
    # The JAX driver's 12-pad: 36 rows are 12 at 1/3 resolution, 3 at level 2,
    # 5 back at level 1 against the skip's 6, and the packed matching net's
    # channel concat asserts equal sizes.
    with pytest.raises(AssertionError) as raised:
        jax_predict.run_frame(jax_fwd, stack, CROP_H, CROP_W, full_frame=True)
    assert any(entry.name == "concat_lanes" for entry in raised.traceback)

    got = predict.run_frame(predict.make_forward(port), stack, CROP_H, CROP_W, True, True, port.size_multiple)
    left, right, _ = jax_test_transform(stack, PAD_H, PAD_W)
    ref = np.asarray(jax_fwd(left[None], right[None]), np.float32)[0, PAD_H - FRAME_H :, PAD_W - FRAME_W :]
    assert got.shape == ref.shape == (FRAME_H, FRAME_W)
    assert np.isfinite(got).all() and ref.std() > 0.1
    err = np.abs(got - ref).max()
    assert err < TOL_PX, err
