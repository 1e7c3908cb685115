"""The port's disparity-sharded eval forward (``cost_volume_pspec``, the CP
analog of ``tests/test_multichip.py:19-79``) on 2 gloo ranks of the CPU,
against the JAX package's *unsharded* forward on the same weights:
``BEST_SCENEFLOW`` at full width, fp32, 48x72, maxdisp 48 (D = 16, 8 planes
a rank), with and without ``return_entropy``. Every rank must return the
whole map, within ``rtol=atol=1e-4`` of JAX as the JAX test holds its own
sharded forward. ``tests/test_torch_parallel_shard_md.py`` does the same at
maxdisp 408 on 4 ranks (uneven shards).

The weights are the port's seeded init with perturbed BN, carried into the
JAX tree, and the ``last_3`` kernel is scaled so the cost spans a few units
(as ``tests/test_torch_model.py``). The JAX reference runs once, with
``return_entropy``, which gives both maps (its plain head, as under a pspec).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leastereo_tpu.models import LEAStereoConfig as JaxConfig
from leastereo_tpu.models import best_sceneflow_model as jax_best
from leastereo_tpu.utils.torch_convert import import_torch_state_dict
from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from test_torch_model import _perturbed_state_dict
from torch_parallel_worker import run_ranks

H, W = 48, 72
TOL = 1e-4  # rtol and atol, as tests/test_multichip.py:48,81


def sharded_against_jax(tmp_path, maxdisp: int, ranks: int, seed: int) -> dict:
    """The sharded forward on ``ranks`` ranks and the JAX unsharded forward
    on the same seeded weights and frame."""
    rng = np.random.RandomState(seed)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    right = rng.randn(1, H, W, 3).astype(np.float32)
    config = dict(maxdisp=maxdisp, compute_dtype="float32")
    port = best_sceneflow_model(LEAStereoConfig(**config), device="cpu")
    sd = _perturbed_state_dict(port, rng)
    with torch.no_grad():
        feats = port.feature(torch.from_numpy(np.concatenate([left, right])).permute(0, 3, 1, 2))
        cost = port.matching.last_3(port.matching(feats[:1], feats[1:], maxdisp // 3))
        sd["matching.last_3.conv.weight"].mul_(3.0 / cost.std())

    jax_model = jax_best(JaxConfig(**config, return_entropy=True))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, import_torch_state_dict(shapes, sd))
    disp, entropy = jax.jit(jax_model.apply)(variables, left, right)

    outs = run_ranks(tmp_path, ranks, "forward", disp=ranks, config=config, state_dict=sd, left=left, right=right)
    return {"disp": np.asarray(disp), "entropy": np.asarray(entropy), "outs": outs}


def check_sharded(run: dict, ranks: int) -> None:
    disp, entropy = run["disp"], run["entropy"]
    assert disp.shape == (1, H, W) and disp.std() > 1.0  # an informative cost, not a flat one
    assert len(run["outs"]) == ranks
    for out in run["outs"]:
        np.testing.assert_allclose(out["entropy=False"].numpy(), disp, rtol=TOL, atol=TOL)
        got, got_entropy = out["entropy=True"]
        np.testing.assert_allclose(got.numpy(), disp, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_entropy.numpy(), entropy, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_disparity_sharded_forward_matches_jax(tmp_path):
    check_sharded(sharded_against_jax(tmp_path, 48, 2, seed=1), 2)
