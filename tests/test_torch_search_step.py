"""One search weight step, then one arch step, of the port
(leastereo_tpu_torch/search/bilevel.py) against the JAX package's, on the
CPU in fp32, at the tiny supernet of tests/test_search.py:77-89 (3 layers,
filter 2, block 2, steps 2, 24x48, maxdisp 12, batch 2).

JAX's side is the loss of ``make_search_steps`` (search/bilevel.py:100-114)
under one jit of ``jax.value_and_grad``, evaluated at the weights before
each step, with JAX's own ``make_weight_tx`` / ``make_arch_tx`` applied to
its gradients: the arithmetic of the two jitted steps, one compile in place
of two. Bounds: the weight step's loss within 1e-4 relative; the arch step's
loss within 1e-3 (its forward already carries the first update, whose
gradients differ by a few percent through train-mode BN); alpha and beta
gradients within 5e-2 per-tensor relative L2; weight gradients as
tests/test_torch_train_grad.py (median 5e-2, worst 0.15); running
statistics after the weight step within 1e-5 of JAX's (that forward runs on
the initial weights); remat on against off to 1e-6 after both steps.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leastereo_tpu.search import AutoStereoSupernet as JaxSupernet
from leastereo_tpu.search import SupernetConfig as JaxConfig
from leastereo_tpu.search import cosine_iter_schedule as jax_cosine
from leastereo_tpu.search import make_arch_tx, make_weight_tx
from leastereo_tpu.train.losses import smooth_l1 as jax_smooth_l1
from leastereo_tpu_torch.ops.cost_volume import build_cost_volume
from leastereo_tpu_torch.search import (
    AutoStereoSupernet,
    SupernetConfig,
    arch_step,
    cosine_iter_schedule,
    make_arch_optimizer,
    make_weight_optimizer,
    weight_step,
)
from leastereo_tpu_torch.utils.weights import supernet_state_dict_from_jax
from test_torch_search import _stats, check_stats, fill_variables, one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_grad import _check_rel_l2

LAYERS, FILTER, BLOCK, STEPS = 3, 2, 2, 2
MAXDISP, H, W, B = 12, 24, 48, 2
LR, TOTAL_ITERS, MIN_LR = 0.025, 10, 1e-3
TOL_W_LOSS, TOL_A_LOSS = 1e-4, 1e-3
TOL_ARCH_GRAD = 5e-2
TOL_REMAT_STATS = 1e-6
ARCH = ("feature.alphas", "feature.betas", "matching.alphas", "matching.betas")


def _batch(rng):
    target = rng.uniform(0.0, MAXDISP - 0.5, size=(B, H, W)).astype(np.float32)
    target[:, ::7, ::5] = 0.0  # counted by the search loss (no lower bound), not by the metrics
    target[:, 3::11, 1::9] = MAXDISP + 3.0  # out of range
    return {"left": rng.randn(B, H, W, 3).astype(np.float32),
            "right": (2.0 * rng.randn(B, H, W, 3)).astype(np.float32), "disparity": target}


def port_supernet(sd, remat=True):
    cfg = SupernetConfig(LAYERS, FILTER, BLOCK, STEPS, remat=remat)
    model = AutoStereoSupernet(MAXDISP, cfg, cfg, dtype=torch.float32)
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True)
    return model


def _by_name(tree) -> dict[str, np.ndarray]:
    sd = supernet_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, tree)})
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _run_port(sd, batch_w, batch_a, remat):
    """Both steps on a fresh port model; what each step saw and left."""
    model = port_supernet(sd, remat=remat)
    opt_w = make_weight_optimizer(model.weight_parameters(), LR)
    opt_a = make_arch_optimizer(model.arch_parameters())
    out = {"p0": {n: p.detach().clone() for n, p in model.named_parameters()}}
    out["m_w"] = weight_step(model, opt_w, batch_w, MAXDISP, cosine_iter_schedule(LR, TOTAL_ITERS, MIN_LR)(0))
    out["g_w"] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    out["p1"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    out["stats1"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["m_a"] = arch_step(model, opt_a, batch_a, MAXDISP)
    out["g_a"] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    out["p2"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    out["stats2"] = model.state_dict()
    return out


@pytest.fixture(scope="module")
def steps():
    rng = np.random.RandomState(11)
    batch_w, batch_a = _batch(rng), _batch(rng)
    model = JaxSupernet(maxdisp=MAXDISP, fea=JaxConfig(LAYERS, FILTER, BLOCK, steps=STEPS),
                        mat=JaxConfig(LAYERS, FILTER, BLOCK, steps=STEPS), dtype=jnp.float32)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = fill_variables(jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x), rng)
    sd = supernet_state_dict_from_jax(variables)
    # Scale last_3 so the train-mode cost spans a few units.
    probe = port_supernet(sd).train()
    with torch.no_grad():
        fl, fr = (probe.feature(torch.from_numpy(batch_w[k]).permute(0, 3, 1, 2)) for k in ("left", "right"))
        scale = 3.0 / float(probe.matching(build_cost_volume(fl, fr, MAXDISP // 3)).std())
    variables["params"]["matching"]["last_3"]["conv"]["kernel"] *= scale
    sd["matching.last_3.conv.weight"] = sd["matching.last_3.conv.weight"] * scale

    def loss_fn(params, batch_stats, batch):
        disp, updates = model.apply({"params": params, "batch_stats": batch_stats}, batch["left"], batch["right"],
                                    train=True, mutable=["batch_stats"])
        target = batch["disparity"]
        mask = target < MAXDISP
        loss = jnp.sum(jax_smooth_l1(disp.astype(jnp.float32) - target) * mask) / jnp.maximum(mask.sum(), 1)
        return loss, updates["batch_stats"]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params0, stats0 = variables["params"], variables["batch_stats"]
    tx_w = make_weight_tx(params0, jax_cosine(LR, TOTAL_ITERS, MIN_LR))
    tx_a = make_arch_tx(params0)
    (loss_w, stats1), g_w = grad_fn(params0, stats0, batch_w)
    upd, _ = tx_w.update(g_w, tx_w.init(params0), params0)
    params1 = optax.apply_updates(params0, upd)
    (loss_a, stats2), g_a = grad_fn(params1, stats1, batch_a)
    upd, _ = tx_a.update(g_a, tx_a.init(params1), params1)
    params2 = optax.apply_updates(params1, upd)
    port = _run_port(sd, batch_w, batch_a, remat=True)
    # JAX's arch gradient at the port's own state after its weight step.
    at_port = _to_jax(variables, port["stats1"])
    (loss_a_port, _), g_a_port = grad_fn(at_port["params"], at_port["batch_stats"], batch_a)
    jax_side = dict(loss_w=float(loss_w), loss_a=float(loss_a), g_w=_by_name(g_w), g_a=_by_name(g_a),
                    stats1=_stats(stats1), loss_a_at_port=float(loss_a_port), g_a_at_port=_by_name(g_a_port))
    return dict(jax=jax_side, port=port, sd=sd, batches=(batch_w, batch_a))


def _to_jax(template, state: dict[str, torch.Tensor]) -> dict:
    """The port's ``state`` (a state_dict) as a JAX variables tree shaped
    like ``template``: the inverse of ``supernet_state_dict_from_jax``."""
    out = {}
    for path, leaf in flax.traverse_util.flatten_dict(template).items():
        names = supernet_state_dict_from_jax(flax.traverse_util.unflatten_dict({path: leaf}))
        (name,) = [k for k in names if not k.endswith("num_batches_tracked")]
        v = state[name].numpy()
        if path[-1] == "kernel":  # OIDHW -> DHWIO / OIHW -> HWIO
            v = v.transpose((2, 3, 4, 1, 0) if v.ndim == 5 else (2, 3, 1, 0))
        out[path] = np.ascontiguousarray(v)
    return flax.traverse_util.unflatten_dict(out)


def test_weight_step_matches_jax(steps):
    j, t = steps["jax"], steps["port"]
    np.testing.assert_allclose(t["m_w"]["loss"], j["loss_w"], rtol=TOL_W_LOSS)
    weights = {k: v for k, v in j["g_w"].items() if k not in ARCH}
    assert set(t["g_w"]) == set(weights)  # no gradient reached alphas or betas
    _check_rel_l2({k: g.numpy() for k, g in t["g_w"].items()}, weights)
    # The running statistics after the first forward (remat on).
    check_stats(t["stats1"], j["stats1"])


def test_arch_step_matches_jax(steps):
    """The arch step's loss against JAX's two-step run; its alpha and beta
    gradients against JAX's at the same weights and statistics (the port's
    after its weight step: from JAX's own, whose weights differ by the
    first update's few-percent gradient differences, the feature alphas'
    gradient differs by ~7%, printed as ``trajectory``)."""
    j, t = steps["jax"], steps["port"]
    np.testing.assert_allclose(t["m_a"]["loss"], j["loss_a"], rtol=TOL_A_LOSS)
    np.testing.assert_allclose(t["m_a"]["loss"], j["loss_a_at_port"], rtol=TOL_W_LOSS)
    assert set(t["g_a"]) == set(ARCH)  # no gradient reached a weight
    for k in ARCH:
        g = t["g_a"][k].double().numpy()
        rel, traj = (np.linalg.norm(g - w) / np.linalg.norm(w) for w in (j["g_a_at_port"][k], j["g_a"][k]))
        print(f"{k} gradient rel L2 {rel:.4g} (trajectory {traj:.4g})")
        assert rel < TOL_ARCH_GRAD, (k, rel)
    for k in ("loss", "epe", "err3"):
        assert np.isfinite(t["m_a"][k]) and np.isfinite(t["m_w"][k])


def test_steps_update_only_their_side(steps):
    """The weight step leaves alphas and betas bit-equal and moves every
    weight; the arch step leaves every weight bit-equal and moves every
    alpha and beta tensor."""
    t = steps["port"]
    for k, p0 in t["p0"].items():
        if k in ARCH:
            assert torch.equal(t["p1"][k], p0), k
            assert not torch.equal(t["p2"][k], t["p1"][k]), k
        else:
            assert not torch.equal(t["p1"][k], p0), k
            assert torch.equal(t["p2"][k], t["p1"][k]), k


def test_remat_running_stats_match_no_remat(steps):
    """After both steps, remat on and off leave the same running statistics
    (the recomputation in the backward pass does not move them) and the same
    parameters."""
    off = _run_port(steps["sd"], *steps["batches"], remat=False)
    on = steps["port"]
    for k, v in off["stats2"].items():
        if k.endswith("num_batches_tracked"):
            assert int(on["stats2"][k]) == int(v), k
        elif "running" in k:
            torch.testing.assert_close(on["stats2"][k], v, rtol=TOL_REMAT_STATS, atol=TOL_REMAT_STATS, msg=k)
    assert on["m_w"]["loss"] == pytest.approx(off["m_w"]["loss"], rel=1e-6)
    assert on["m_a"]["loss"] == pytest.approx(off["m_a"]["loss"], rel=1e-6)


def test_optimizers_match_optax():
    """The same gradients (a new seeded draw each step) fed to the port's
    optimizers and to JAX's ``make_weight_tx`` / ``make_arch_tx`` give the
    same updates to 1e-6 over three steps, the weight lr following the
    cosine schedule by update count; the schedules agree. Both sides run in
    float64: the port's update is a difference of two parameter values,
    which fp32 spacing would quantise, and optax in fp32 rounds Adam's
    ``1 - 0.999`` to 9.9998713e-4, which alone moves its first update by
    6.4e-6 relative."""
    with jax.enable_x64(True):
        _optimizer_steps()


def _optimizer_steps():
    rng = np.random.RandomState(5)
    params = {"net": {"alphas": rng.randn(9, 2), "betas": rng.randn(6, 4, 3), "conv": {"kernel": rng.randn(3, 3, 4, 4)}}}
    sched_j, sched_t = jax_cosine(LR, 3, MIN_LR), cosine_iter_schedule(LR, 3, MIN_LR)
    for t in range(5):
        assert sched_t(t) == pytest.approx(float(sched_j(t)), rel=1e-12)
    tx_w, tx_a = make_weight_tx(params, sched_j), make_arch_tx(params)
    st_w, st_a = tx_w.init(params), tx_a.init(params)
    names = (("alphas",), ("betas",), ("conv", "kernel"))
    tensors = {n: torch.nn.Parameter(torch.from_numpy(np.array(_get(params["net"], n)))) for n in names}
    opt_w = make_weight_optimizer([tensors[("conv", "kernel")]], LR)
    opt_a = make_arch_optimizer([tensors[("alphas",)], tensors[("betas",)]])
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape), params)
        for tx, st, opt, lr in ((tx_w, st_w, opt_w, sched_t(step)), (tx_a, st_a, opt_a, None)):
            upd, new_st = tx.update(grads, st, params)
            for n, p in tensors.items():
                p.grad = torch.from_numpy(np.array(_get(grads["net"], n)))
            before = {n: p.detach().clone() for n, p in tensors.items()}
            if lr is not None:
                for group in opt.param_groups:
                    group["lr"] = lr
            opt.step()
            moved = {n for g in opt.param_groups for n, p in tensors.items() if any(p is q for q in g["params"])}
            for n in names:
                want = np.asarray(_get(upd["net"], n))
                got = (tensors[n].detach() - before[n]).numpy()
                if n in moved:
                    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(), err_msg=str(n))
                else:
                    assert not want.any() and not got.any(), n
            params = optax.apply_updates(params, upd)
            for n, p in tensors.items():
                with torch.no_grad():
                    p.copy_(torch.from_numpy(np.array(_get(params["net"], n))))
            if tx is tx_w:
                st_w = new_st
            else:
                st_a = new_st


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
