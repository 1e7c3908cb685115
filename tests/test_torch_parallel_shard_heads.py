"""The port's disparity-sharded eval forward with its two other options, on
2 gloo ranks of the CPU: ``fast_head`` (a
softmax over D whose maximum and sums reduce over the disp ranks) and
``fused_stem=False`` (each rank builds its planes of the explicit volume).
Each against JAX's own sharded forward (``cost_volume_pspec=("data",
"disp")`` under a ``disp=2`` mesh of the host's devices, as
``tests/test_multichip.py:18-47`` holds JAX's), one JAX compile for both.

``BEST_SCENEFLOW`` at full width, fp32, 48x72, maxdisp 48 (D = 16, 8 planes
a rank), the weights of ``tests/test_torch_parallel_shard.py`` (seeded init,
perturbed BN, the cost scaled to span a few units). Every rank returns the
whole map, within ``rtol=atol=1e-4`` of JAX as the JAX test holds its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leastereo_tpu.models import LEAStereoConfig as JaxConfig
from leastereo_tpu.models import best_sceneflow_model as jax_best
from leastereo_tpu.parallel import make_mesh as jax_mesh
from leastereo_tpu.utils.torch_convert import import_torch_state_dict
from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from test_torch_model import _perturbed_state_dict
from test_torch_parallel_shard import TOL
from torch_parallel_worker import run_ranks

H, W, MAXDISP, RANKS = 48, 72, 48, 2
CONFIG = dict(maxdisp=MAXDISP, compute_dtype="float32")
VARIANTS = {"fast_head": {"fast_head": True}, "fused_stem=False": {"fused_stem": False}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(5)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    right = rng.randn(1, H, W, 3).astype(np.float32)
    port = best_sceneflow_model(LEAStereoConfig(**CONFIG), device="cpu")
    sd = _perturbed_state_dict(port, rng)
    with torch.no_grad():
        feats = port.feature(torch.from_numpy(np.concatenate([left, right])).permute(0, 3, 1, 2))
        cost = port.matching.last_3(port.matching(feats[:1], feats[1:], MAXDISP // 3))
        sd["matching.last_3.conv.weight"].mul_(3.0 / cost.std())

    shapes = jax.eval_shape(jax_best(JaxConfig(**CONFIG)).init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                            jnp.zeros((1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, import_torch_state_dict(shapes, sd))
    models = {k: jax_best(JaxConfig(**CONFIG, **v, cost_volume_pspec=("data", "disp"))) for k, v in VARIANTS.items()}
    mesh = jax_mesh(data=1, disp=RANKS)
    with jax.sharding.set_mesh(mesh):
        want = jax.jit(lambda l, r: {k: m.apply(variables, l, r) for k, m in models.items()})(left, right)
    outs = run_ranks(tmp_path_factory.mktemp("shard_heads"), RANKS, "forward", disp=RANKS, config=CONFIG,
                     state_dict=sd, left=left, right=right, variants=VARIANTS)
    return {k: np.asarray(v) for k, v in want.items()}, outs


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sharded_forward_variant_matches_jax(runs, variant):
    want, outs = runs
    assert want[variant].shape == (1, H, W) and want[variant].std() > 1.0  # an informative cost
    assert len(outs) == RANKS
    for out in outs:
        np.testing.assert_allclose(out[variant].numpy(), want[variant], rtol=TOL, atol=TOL, err_msg=variant)
