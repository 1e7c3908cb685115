"""The port's NAS search modules (leastereo_tpu_torch/search) against the JAX
package's, on the CPU in fp32: the numpy decoder copy, ``normalize_betas``,
``SearchCell`` (2-D and 3-D, every branch set, with and without s0), the
whole ``AutoStereoSupernet`` in eval and train mode, and the weight mapping.

Weights are seeded numpy draws on the JAX tree (``jax.eval_shape`` of
``init``, nothing compiled), carried to the port by
``supernet_state_dict_from_jax``; JAX cells run eagerly, and the whole
supernet compiles once (eval and train forward in one jit).
"""

import filecmp
import math

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leastereo_tpu.search import AutoStereoSupernet as JaxSupernet
from leastereo_tpu.search import SearchCell as JaxSearchCell
from leastereo_tpu.search import SupernetConfig as JaxConfig
from leastereo_tpu.search import decode as jax_decode
from leastereo_tpu.search import normalize_betas as jax_normalize_betas
from leastereo_tpu_torch.ops.cost_volume import build_cost_volume
from leastereo_tpu_torch.search import AutoStereoSupernet, SearchCell, SupernetConfig, decode, normalize_betas
from leastereo_tpu_torch.utils.weights import supernet_state_dict_from_jax

# The oracle's structurally complete config (tests/test_supernet_oracle.py:38-45):
# 4 layers reach every trellis pattern (layer 0/1/2/>=3, all four levels).
LAYERS, FILTER, BLOCK, STEPS = 4, 2, 4, 3
MAXDISP, H, W, B = 48, 48, 96, 2
ARCH_SCALE = 300.0  # 1e-3-scale alphas/betas x300: the ops are really mixed
TOL_CELL_REL = 1e-5
TOL_EVAL_PX = 1e-3
# Train-mode BN renormalises rounding with batch statistics through the
# trellis (the oracle's bounds, tests/test_supernet_oracle.py:197-198).
TOL_TRAIN_MAX_PX, TOL_TRAIN_MEAN_PX = 2e-2, 2e-3
TOL_STATS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread while the module runs. Beside other
    test workers (pytest-xdist) its thread pool oversubscribes the cores and
    the supernet's many small ops stall on each other: the remat test took
    4.8 s alone and 433 s beside five workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fill_variables(shapes, rng: np.random.RandomState, arch_scale: float = ARCH_SCALE) -> dict:
    """Seeded values for every leaf of a JAX variables tree of ``shapes``:
    He-normal (fan-out) kernels, perturbed BN affines and statistics, and
    ``arch_scale * 1e-3 * N(0, 1)`` alphas and betas."""
    out = {}
    for path, s in sorted(flax.traverse_util.flatten_dict(shapes).items()):
        leaf, shape = path[-1], tuple(s.shape)
        if leaf == "kernel":
            v = rng.randn(*shape) * math.sqrt(2.0 / (math.prod(shape[:-2]) * shape[-1]))
        elif leaf == "scale":
            v = 1.0 + 0.2 * rng.randn(*shape)
        elif leaf in ("bias", "mean"):
            v = 0.1 * rng.randn(*shape)
        elif leaf == "var":
            v = np.exp(0.3 * rng.randn(*shape))
        elif leaf in ("alphas", "betas"):
            v = arch_scale * 1e-3 * rng.randn(*shape)
        else:
            raise KeyError(path)
        out[path] = v.astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def _stats(batch_stats) -> dict[str, np.ndarray]:
    sd = supernet_state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, batch_stats)})
    return {k: v.numpy() for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def check_stats(got: dict, want: dict, tol: float = TOL_STATS) -> None:
    """Every running mean and var of ``want`` in ``got`` (a port state_dict),
    relative, with the tensor's largest entry as the floor for entries near 0."""
    assert want and set(want) <= set(got)
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=tol, atol=tol * np.abs(w).max(), err_msg=k)


# ------------------------------------------------------------- decoder -----


@pytest.mark.parametrize("num_layers", [6, 12])
def test_decode_copy_matches_jax(num_layers, tmp_path):
    """Path, one-hot space and genotype exactly equal on 20 seeded draws;
    the saved files byte-equal."""
    rng = np.random.RandomState(num_layers)
    for trial in range(20):
        alphas = rng.randn(9, 2).astype(np.float32)
        betas = rng.randn(num_layers, 4, 3).astype(np.float32)
        got, want = decode.decode_arch(alphas, betas, STEPS), jax_decode.decode_arch(alphas, betas, STEPS)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(decode.normalize_betas_np(betas), jax_decode.normalize_betas_np(betas))
    paths_t = decode.save_decoded(str(tmp_path / "port"), got, got)
    paths_j = jax_decode.save_decoded(str(tmp_path / "jax"), want, want)
    assert paths_t.keys() == paths_j.keys()
    for k in paths_t:
        assert filecmp.cmp(paths_t[k], paths_j[k], shallow=False), k


@pytest.mark.parametrize("num_layers", [6, 12])
def test_normalize_betas_matches_jax(num_layers):
    """Values to 1e-7, and the gradient of a random projection."""
    rng = np.random.RandomState(num_layers + 1)
    betas = rng.randn(num_layers, 4, 3).astype(np.float32)
    proj = rng.randn(num_layers, 4, 3).astype(np.float32)
    want, grad_want = jax.value_and_grad(lambda b: jnp.sum(jax_normalize_betas(b, num_layers) * proj))(betas)
    bt = torch.from_numpy(betas).requires_grad_(True)
    got = normalize_betas(bt, num_layers)
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jax_normalize_betas(betas, num_layers)), rtol=0, atol=1e-7)
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(grad_want), rtol=1e-5, atol=1e-6)
    assert float(want) == pytest.approx(float((got.detach() * torch.from_numpy(proj)).sum()), rel=1e-6)


# ---------------------------------------------------------------- cells -----

# Branch inputs land on the same target size: down from twice the size
# (scale_dimension 0.5), up from half (scale_dimension 2).
CELL_SIZES = {2: (8, 12), 3: (4, 8, 8)}
C_S0, C_DOWN, C_SAME, C_UP, C_OUT, CELL_BM = 8, 6, 8, 5, 4, 2
BRANCH_SETS = {"down": (1, 0, 0), "same": (0, 1, 0), "up": (0, 0, 1), "all": (1, 1, 1)}


@pytest.mark.parametrize("has_s0", [True, False])
@pytest.mark.parametrize("branches", list(BRANCH_SETS))
@pytest.mark.parametrize("ndim", [2, 3])
def test_search_cell_matches_jax(ndim, branches, has_s0):
    """Each branch's output in train mode (with the running statistics it
    leaves) and in eval mode, to 1e-5 relative."""
    rng = np.random.RandomState(10 * ndim + len(branches) + has_s0)
    size = CELL_SIZES[ndim]
    down, same, up = BRANCH_SETS[branches]

    def x(c, scale):
        return (rng.randn(B, *(int(d * scale) for d in size), c)).astype(np.float32)

    s0 = x(C_S0, 1.0) if has_s0 else None
    s1 = (x(C_DOWN, 2.0) if down else None, x(C_SAME, 1.0) if same else None, x(C_UP, 0.5) if up else None)
    e = sum(2 + i for i in range(STEPS))
    alphas = np.array(jax.nn.softmax(rng.randn(e, 2).astype(np.float32), axis=-1))

    cell = JaxSearchCell(steps=STEPS, block_multiplier=CELL_BM, c_out=C_OUT, has_s0=has_s0, ndim=ndim,
                         dtype=jnp.float32)
    shapes = jax.eval_shape(lambda key: cell.init(key, s0, *s1, alphas, True), jax.random.PRNGKey(0))
    variables = fill_variables(shapes, rng)
    port = SearchCell(STEPS, CELL_BM, C_S0 if has_s0 else None, *(c if on else None for c, on in
                      zip((C_DOWN, C_SAME, C_UP), (down, same, up))), C_OUT, ndim=ndim)
    port.load_state_dict(supernet_state_dict_from_jax(variables), strict=True)

    def nchw(a):
        return None if a is None else torch.from_numpy(np.moveaxis(a, -1, 1).copy())

    args_t = (nchw(s0), *map(nchw, s1), torch.from_numpy(alphas))
    for train in (False, True):  # eval first: train mode moves the running statistics
        if train:
            want, upd = cell.apply(variables, s0, *s1, alphas, True, mutable=["batch_stats"])
        else:
            want = cell.apply(variables, s0, *s1, alphas, False)
        with torch.no_grad():
            got = port.train(train)(*args_t)
        assert len(got) == len(want) == down + same + up
        for g, w in zip(got, want):
            w = np.moveaxis(np.asarray(w), -1, 1)
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL_CELL_REL, atol=TOL_CELL_REL * np.abs(w).max())
        if train:
            check_stats(port.state_dict(), _stats(upd["batch_stats"]))


# ------------------------------------------------------------- supernet -----


def jax_supernet():
    cfg = JaxConfig(LAYERS, FILTER, BLOCK, STEPS, remat=False)
    return JaxSupernet(maxdisp=MAXDISP, fea=cfg, mat=cfg, dtype=jnp.float32)


def port_supernet(sd: dict, remat: bool = True) -> AutoStereoSupernet:
    cfg = SupernetConfig(LAYERS, FILTER, BLOCK, STEPS, remat=remat)
    model = AutoStereoSupernet(MAXDISP, cfg, cfg, dtype=torch.float32)
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True)
    return model


@pytest.fixture(scope="module")
def supernet_setup():
    """JAX variables (seeded), the port's state_dict of them, and the
    inputs: a right view of twice the left's spread, so per-view and pooled
    BN statistics differ. ``sd_train`` / ``sd_eval`` (and the JAX
    ``variables_train`` / ``variables_eval``) have the matching ``last_3``
    kernel scaled so that mode's cost spans a few units: random weights give
    a cost where the softmin degenerates to a hard argmin."""
    rng = np.random.RandomState(3)
    left = rng.randn(B, H, W, 3).astype(np.float32)
    right = (2.0 * rng.randn(B, H, W, 3)).astype(np.float32)
    model = jax_supernet()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), left[:1], left[:1])
    variables = fill_variables(shapes, rng)
    sd = supernet_state_dict_from_jax(variables)
    out = dict(variables=variables, sd=sd, left=left, right=right, model=model)
    for mode in ("train", "eval"):
        probe = port_supernet(sd).train(mode == "train")
        with torch.no_grad():
            fl, fr = (probe.feature(torch.from_numpy(x).permute(0, 3, 1, 2)) for x in (left, right))
            scale = 3.0 / float(probe.matching(build_cost_volume(fl, fr, MAXDISP // 3)).std())
        v = jax.tree_util.tree_map(np.copy, variables)
        v["params"]["matching"]["last_3"]["conv"]["kernel"] *= scale
        out[f"variables_{mode}"] = v
        out[f"sd_{mode}"] = {**sd, "matching.last_3.conv.weight": sd["matching.last_3.conv.weight"] * scale}
    return out


@pytest.fixture(scope="module")
def jax_forward(supernet_setup):
    """JAX's eval disparity, train disparity and the running statistics the
    train forward leaves, from one jit (without ``nn.remat``, which changes
    only what the backward pass stores)."""
    s = supernet_setup
    model = s["model"]

    @jax.jit
    def both(v_eval, v_train, l, r):
        train, upd = model.apply(v_train, l, r, train=True, mutable=["batch_stats"])
        return model.apply(v_eval, l, r, train=False), train, upd["batch_stats"]

    ev, tr, stats = both(s["variables_eval"], s["variables_train"], s["left"], s["right"])
    return np.asarray(ev), np.asarray(tr), _stats(stats)


def test_supernet_state_dict_from_jax_loads_strictly(supernet_setup):
    """Every JAX leaf lands on its own port tensor, and the port's
    state_dict has nothing else but the BN counters."""
    s = supernet_setup
    leaves = flax.traverse_util.flatten_dict(s["variables"])
    sd = s["sd"]
    assert len([k for k in sd if not k.endswith("num_batches_tracked")]) == len(leaves)
    port = port_supernet(sd)
    assert set(port.state_dict()) == set(sd)
    assert len(port.feature.cells) == len(port.matching.cells) == 2 + 3 + 4 + 4
    assert port.state_dict()["matching.cells.12._ops.8._ops.1.conv.weight"].shape == (16, 16, 3, 3, 3)
    assert [p.shape for p in port.arch_parameters()] == [(9, 2), (LAYERS, 4, 3)] * 2
    assert len(port.weight_parameters()) + 4 == len(list(port.parameters()))


def test_supernet_eval_matches_jax(supernet_setup, jax_forward):
    s = supernet_setup
    want = jax_forward[0]
    with torch.no_grad():
        got = port_supernet(s["sd_eval"]).eval()(torch.from_numpy(s["left"]), torch.from_numpy(s["right"])).numpy()
    assert got.shape == want.shape == (B, H, W) and want.std() > 1.0
    diff = np.abs(got - want)
    print(f"eval supernet against JAX: max {diff.max():.4g} px, mean {diff.mean():.4g} px")
    assert diff.max() <= TOL_EVAL_PX, diff.max()


def test_supernet_train_matches_jax(supernet_setup, jax_forward):
    """The train-mode disparity (per-view feature supernet: a joint batch of
    both views pools their BN statistics) and the BN updates it makes, once
    per view in the feature supernet. (Running statistics against JAX's:
    tests/test_torch_search_step.py, at a smaller config; here, four layers
    deep, cancellation in small-n batch means leaves them ~1e-4 apart.)"""
    s = supernet_setup
    _, want, _ = jax_forward
    model = port_supernet(s["sd_train"]).train()
    with torch.no_grad():
        got = model(torch.from_numpy(s["left"]), torch.from_numpy(s["right"])).numpy()
    assert want.std() > 1.0
    diff = np.abs(got - want)
    print(f"train supernet against JAX: max {diff.max():.4g} px, mean {diff.mean():.4g} px")
    assert diff.max() <= TOL_TRAIN_MAX_PX and diff.mean() <= TOL_TRAIN_MEAN_PX, (diff.max(), diff.mean())
    # The feature supernet's BN layers move once per view: twice as often as
    # in one call of the feature supernet on one view.
    one_view = port_supernet(s["sd_train"]).train()
    with torch.no_grad():
        one_view.feature(torch.from_numpy(s["left"]).permute(0, 3, 1, 2))

    def counts(m):
        return {k: int(v) for k, v in m.state_dict().items() if k.endswith("num_batches_tracked")}

    both, once = counts(model), counts(one_view)
    assert all(both[k] == 2 * once[k] > 0 for k in once if k.startswith("feature.cells."))


def test_remat_updates_running_stats_once(supernet_setup):
    """A forward and backward with remat moves every BN running statistic
    as far as without it (the recomputation in the backward pass would move
    them again), and gives the same gradients."""
    s = supernet_setup
    left, right = torch.from_numpy(s["left"]), torch.from_numpy(s["right"])
    runs = {}
    for remat in (True, False):
        model = port_supernet(s["sd_train"], remat=remat).train()
        model(left, right).square().mean().backward()
        runs[remat] = (model.state_dict(), {n: p.grad for n, p in model.named_parameters()})
    (sd_on, g_on), (sd_off, g_off) = runs[True], runs[False]
    for k, v in sd_off.items():
        if k.endswith("num_batches_tracked"):
            assert int(sd_on[k]) == int(v), k
        elif "running" in k:
            torch.testing.assert_close(sd_on[k], v, rtol=1e-6, atol=1e-7, msg=k)
    for k, g in g_off.items():
        torch.testing.assert_close(g_on[k], g, rtol=1e-4, atol=1e-6 * float(g.abs().max()), msg=k)
