"""The port's data-parallel train step (``train/step.py`` with a mesh) on 2
gloo ranks of the CPU, against the port's one-process step on the global
batch and against JAX ``make_train_step`` over a 2-device mesh (as
``tests/test_multichip.py:84-120`` holds JAX's own mesh step).

``BEST_SCENEFLOW`` at full width, fp32, a global batch of 4 at 24x48,
maxdisp 24, Adam; rank 1's rows hold fewer valid pixels than rank 0's, so
a mean of per-rank means would differ from the global masked mean. The
weights are the port's seeded init with perturbed BN, carried into the JAX
tree (no JAX init compiled). Bounds: the loss and EPE of the train step
and of an eval step before it to 1e-5 of the one-process steps, the 3-px
error to 2 pixels; the BN running statistics, gradients and parameter
updates to the fp32 noise floor of this network, measured here as the
one-process step on the same rows in another order
(``test_torch_parallel.check_within_noise``); the loss to JAX's within the
port's train tolerance (``tests/test_torch_train_grad.py``, rtol 1e-3).
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

B, H, W, MAXDISP = 4, 24, 48, 24
LR = 1e-3
CONFIG = dict(maxdisp=MAXDISP, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(3)
    port = best_sceneflow_model(LEAStereoConfig(**CONFIG), device="cpu")
    sd = {k: v.clone() for k, v in _perturbed_state_dict(port, rng).items()}
    target = rng.uniform(0.5, MAXDISP - 1, size=(B, H, W)).astype(np.float32)
    target[:, ::7, ::5] = 0.0  # occlusions
    target[2:, : H // 2] = MAXDISP + 10.0  # rank 1's rows: half out of range
    batch = {"left": rng.randn(B, H, W, 3).astype(np.float32),
             "right": (2.0 * rng.randn(B, H, W, 3)).astype(np.float32), "disparity": target}
    return sd, batch


def one_process_step(sd: dict, batch: dict, order) -> dict:
    model = best_sceneflow_model(LEAStereoConfig(**CONFIG), device="cpu")
    model.load_state_dict({k: v.clone() for k, v in sd.items()})
    opt = make_optimizer(model.parameters(), "adam", LR)
    rows = {k: v[order] for k, v in batch.items()}
    eval_metrics = eval_step(model, rows, MAXDISP)[1]
    metrics = train_step(model, opt, rows, MAXDISP, LR)
    return {"metrics": metrics, "grads": {n: p.grad for n, p in model.named_parameters()},
            "state": model.state_dict(), "eval_metrics": eval_metrics}


def test_train_step_data_parallel(setup, tmp_path):
    sd, batch = setup
    valid = ((batch["disparity"] > 0.001) & (batch["disparity"] < MAXDISP)).reshape(2, -1).sum(axis=1)
    assert valid[0] > 1.5 * valid[1]  # the ranks' valid-pixel counts differ
    want = one_process_step(sd, batch, [0, 1, 2, 3])
    reordered = one_process_step(sd, batch, [2, 3, 0, 1])
    outs = run_ranks(tmp_path, 2, "train_step", data=2, config=CONFIG, state_dict=sd, batch=batch, lr=LR)

    params = list(want["grads"])
    stats = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
    for out in outs:
        for got, ref in ((out["metrics"], want["metrics"]), (out["eval_metrics"], want["eval_metrics"])):
            for k in ("loss", "epe") if "loss" in ref else ("epe",):
                np.testing.assert_allclose(got[k], ref[k], rtol=TOL_METRICS, err_msg=k)
            # 3-px error counts pixels: two may cross the threshold by rounding.
            assert abs(got["err3"] - ref["err3"]) <= 2 / valid.sum()
        check_within_noise(out["grads"], want["grads"], reordered["grads"], "gradients")
        check_within_noise(*({n: r["state"][n] - sd[n] for n in params} for r in (out, want, reordered)), "updates")
        check_within_noise(*({k: r["state"][k] for k in stats} for r in (out, want, reordered)), "BN stats")
    assert all(torch.equal(outs[0]["state"][k], outs[1]["state"][k]) for k in want["state"])  # replicas agree

    # JAX's data-parallel step over a 2-device mesh, same weights and batch.
    jax_model = jax_best(JaxConfig(**CONFIG))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, import_torch_state_dict(shapes, sd))
    state = TrainState.create(apply_fn=jax_model.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"], tx=jax_optimizer("adam", LR))
    mesh = jax_mesh(data=2, disp=1)
    with jax.sharding.set_mesh(mesh):
        _, m = make_train_step(MAXDISP, mesh=mesh, donate=False)(state, batch)
    np.testing.assert_allclose(outs[0]["metrics"]["loss"], float(m["loss"]), rtol=TOL_LOSS)
    np.testing.assert_allclose(outs[0]["metrics"]["epe"], float(m["epe"]), rtol=TOL_LOSS)
