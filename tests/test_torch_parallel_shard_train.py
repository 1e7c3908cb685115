"""The port's disparity-sharded train step (``train/step.py`` over a mesh
with ``disp > 1``, ``cost_volume_pspec=("data", "disp")``) on gloo ranks of
the CPU, against the port's one-process step on the same global batch and
against JAX ``make_train_step`` over a ``disp=2`` mesh of the host's
devices (JAX's own disparity-sharded train step, as ``__graft_entry__.py``
``dryrun_multichip`` runs it).

``BEST_SCENEFLOW`` at full width, fp32, a global batch of 2 at 24x48,
maxdisp 24 (D = 8: 4 planes a disp rank, 1 at the deepest level), Adam.
Two meshes: 1x2 (data 1, disp 2) and 2x2 (4 ranks, one row each). The 2x2
mesh tells the BatchNorm groups apart: the matching net's statistics span
both axes, the feature net's the data axis only.

The weights are the port's seeded init with perturbed BN and the ``last_3``
kernel scaled so the cost spans a few units, carried into the JAX tree.
Bounds, as ``tests/test_torch_parallel_train.py``: the loss and EPE of the
train step and of an eval step before it to 1e-5 of the one-process steps,
the 3-px error to 2 pixels; the BN running statistics, gradients and
parameter updates to the fp32 noise floor (the one-process step on the same
rows in another order, ``test_torch_parallel.check_within_noise``); every
rank's parameters and statistics equal after the step; the loss and EPE to
JAX's within the port's train tolerance (``tests/test_torch_train_grad.py``,
rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leastereo_tpu.models import LEAStereoConfig as JaxConfig
from leastereo_tpu.models import best_sceneflow_model as jax_best
from leastereo_tpu.parallel import make_mesh as jax_mesh
from leastereo_tpu.train import TrainState, make_train_step
from leastereo_tpu.train import make_optimizer as jax_optimizer
from leastereo_tpu.utils.torch_convert import import_torch_state_dict
from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.train import eval_step, make_optimizer, train_step
from test_torch_model import _perturbed_state_dict
from test_torch_parallel import TOL_METRICS, check_within_noise
from test_torch_train_grad import TOL_LOSS
from torch_parallel_worker import run_ranks

B, H, W, MAXDISP = 2, 24, 48, 24
LR = 1e-3
CONFIG = dict(maxdisp=MAXDISP, compute_dtype="float32")
SHARDED = dict(CONFIG, cost_volume_pspec=("data", "disp"))
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(11)
    port = best_sceneflow_model(LEAStereoConfig(**CONFIG), device="cpu")
    sd = _perturbed_state_dict(port, rng)
    target = rng.uniform(0.5, MAXDISP - 1, size=(B, H, W)).astype(np.float32)
    target[:, ::7, ::5] = 0.0  # occlusions
    target[1, : H // 2] = MAXDISP + 10.0  # row 1: half out of range
    batch = {"left": rng.randn(B, H, W, 3).astype(np.float32),
             "right": (2.0 * rng.randn(B, H, W, 3)).astype(np.float32), "disparity": target}
    # The last_3 kernel scaled so the eval cost spans a few units (as
    # tests/test_torch_model.py): a random net's cost is so wide that its
    # softmin is a hard argmin, whose ties any summation order flips.
    with torch.no_grad():
        feats = port.feature(torch.from_numpy(np.concatenate([batch["left"], batch["right"]])).permute(0, 3, 1, 2))
        cost = port.matching.last_3(port.matching(feats[:B], feats[B:], MAXDISP // 3))
        sd["matching.last_3.conv.weight"].mul_(3.0 / cost.std())
    return {k: v.clone() for k, v in sd.items()}, batch


def one_process_step(sd: dict, batch: dict, order) -> dict:
    model = best_sceneflow_model(LEAStereoConfig(**CONFIG), device="cpu")
    model.load_state_dict({k: v.clone() for k, v in sd.items()})
    opt = make_optimizer(model.parameters(), "adam", LR)
    rows = {k: v[order] for k, v in batch.items()}
    eval_metrics = eval_step(model, rows, MAXDISP)[1]
    metrics = train_step(model, opt, rows, MAXDISP, LR)
    return {"metrics": metrics, "grads": {n: p.grad for n, p in model.named_parameters()},
            "state": model.state_dict(), "eval_metrics": eval_metrics}


@pytest.fixture(scope="module")
def one_process(setup):
    sd, batch = setup
    return one_process_step(sd, batch, [0, 1]), one_process_step(sd, batch, [1, 0])


@pytest.fixture(scope="module")
def sharded(setup, tmp_path_factory):
    """Each mesh's ranks' outputs, run once for the module."""
    sd, batch = setup
    runs = {}

    def run(name):
        if name not in runs:
            data, disp = MESHES[name]
            runs[name] = run_ranks(tmp_path_factory.mktemp(f"shard_train_{name}"), data * disp, "train_step",
                                   data=data, disp=disp, config=SHARDED, state_dict=sd, batch=batch, lr=LR)
        return runs[name]

    return run


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_train_step_matches_one_process(setup, one_process, sharded, mesh):
    sd, batch = setup
    want, reordered = one_process
    outs = sharded(mesh)
    assert len(outs) == np.prod(MESHES[mesh])
    valid = ((batch["disparity"] > 0.001) & (batch["disparity"] < MAXDISP)).sum()
    params = list(want["grads"])
    stats = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
    for out in outs:
        for got, ref in ((out["metrics"], want["metrics"]), (out["eval_metrics"], want["eval_metrics"])):
            for k in ("loss", "epe") if "loss" in ref else ("epe",):
                np.testing.assert_allclose(got[k], ref[k], rtol=TOL_METRICS, err_msg=k)
            # 3-px error counts pixels: two may cross the threshold by rounding.
            assert abs(got["err3"] - ref["err3"]) <= 2 / valid
        check_within_noise(out["grads"], want["grads"], reordered["grads"], "gradients")
        check_within_noise(*({n: r["state"][n] - sd[n] for n in params} for r in (out, want, reordered)), "updates")
        check_within_noise(*({k: r["state"][k] for k in stats} for r in (out, want, reordered)), "BN stats")
    for out in outs[1:]:  # every rank's parameters and running statistics move alike
        assert all(torch.equal(outs[0]["state"][k], out["state"][k]) for k in want["state"])


def test_sharded_train_step_matches_jax(setup, sharded):
    """JAX's disparity-sharded train step over a ``disp=2`` mesh of two host
    devices, on the same weights and batch, against the port's 1x2 mesh."""
    sd, batch = setup
    outs = sharded("1x2")
    jax_model = jax_best(JaxConfig(**SHARDED))
    shapes = jax.eval_shape(jax_best(JaxConfig(**CONFIG)).init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, import_torch_state_dict(shapes, sd))
    state = TrainState.create(apply_fn=jax_model.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"], tx=jax_optimizer("adam", LR))
    mesh = jax_mesh(data=1, disp=2)
    with jax.sharding.set_mesh(mesh):
        _, m = make_train_step(MAXDISP, mesh=mesh, donate=False)(state, batch)
    for out in outs:
        np.testing.assert_allclose(out["metrics"]["loss"], float(m["loss"]), rtol=TOL_LOSS)
        np.testing.assert_allclose(out["metrics"]["epe"], float(m["epe"]), rtol=TOL_LOSS)
