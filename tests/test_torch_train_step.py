"""One whole training step of the port against the JAX package's
``make_train_step``, on the CPU: SGD with momentum, whose first update is
``-lr * grad`` and so linear in the gradient. The loss and metrics, each
parameter's update and the BN running stats after the step.

Same setup and bounds as tests/test_torch_train_grad.py (a file of its own,
so that each JAX compile gets its own worker).
"""

import jax
import numpy as np
import pytest

from leastereo_tpu.train import make_optimizer as jax_optimizer
from leastereo_tpu.train import make_train_step
from leastereo_tpu.train.step import TrainState
from leastereo_tpu_torch.train import make_optimizer, train_step
from leastereo_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_train import MAXDISP, TOL_STATS, port_model
from test_torch_train_grad import TOL_LOSS, _by_port_name, _check_rel_l2, grad_setup


@pytest.fixture(scope="module")
def setup():
    return grad_setup()


def test_sgd_step_matches_jax(setup):
    lr = 1.0
    variables = setup["variables"]
    state = TrainState.create(
        apply_fn=setup["jax_model"].apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=jax_optimizer("sgd", lr, momentum=0.9),
    )
    batch = {"left": setup["left"], "right": setup["right"], "disparity": setup["target"]}
    new_state, metrics_j = make_train_step(MAXDISP, donate=False)(state, batch)

    port = port_model(setup["sd"])
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = make_optimizer(port.parameters(), "sgd", lr, momentum=0.9)
    metrics_t = train_step(port, opt, batch, MAXDISP, lr)
    assert port.training
    np.testing.assert_allclose(metrics_t["loss"], float(metrics_j["loss"]), rtol=TOL_LOSS)
    np.testing.assert_allclose(metrics_t["epe"], float(metrics_j["epe"]), rtol=TOL_LOSS)
    valid = ((setup["target"] > 0.001) & (setup["target"] < MAXDISP)).sum()
    assert abs(metrics_t["err3"] - float(metrics_j["err3"])) <= 2 / valid

    old, new = _by_port_name(variables["params"]), _by_port_name(new_state.params)
    _check_rel_l2({n: (p.detach() - before[n]).numpy() for n, p in port.named_parameters()},
                  {k: new[k] - old[k] for k in old})
    stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, new_state.batch_stats)})
    got = port.state_dict()
    for k, v in stats.items():
        if k.endswith(("running_mean", "running_var")):
            w = v.numpy()
            np.testing.assert_allclose(got[k].numpy(), w, rtol=TOL_STATS, atol=TOL_STATS * np.abs(w).max(), err_msg=k)
