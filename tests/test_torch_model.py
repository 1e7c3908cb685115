"""The port's model (leastereo_tpu_torch/models) against the JAX model, on the
same weights and numpy-seeded inputs, fp32 on the CPU, at the small config of
tests/test_model_forward.py (48x96, maxdisp 48).

The weights are the port's seeded init with BN scale, bias, mean and var
perturbed by numpy, carried into the JAX tree through
``leastereo_tpu.utils.torch_convert.import_torch_state_dict``; the matching
``last_3`` kernel is rescaled so the cost spans a few units, where softmin is
neither flat nor a hard argmin and the soft-argmin is well conditioned.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leastereo_tpu.models import LEAStereoConfig as JaxConfig
from leastereo_tpu.models import best_sceneflow_model as jax_best
from leastereo_tpu.models.feature_net import FeatureNet as JaxFeatureNet
from leastereo_tpu.models.genotypes import BEST_SCENEFLOW as JAX_BEST
from leastereo_tpu.utils.torch_convert import import_torch_state_dict
from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.models import BEST_SCENEFLOW, Architecture
from leastereo_tpu_torch.models.matching_net import DEFAULT_SKIPS, MatchingNet
from leastereo_tpu_torch.ops.convbr import ConvBR
from leastereo_tpu_torch.ops.layout import is_ndhwc
from leastereo_tpu_torch.parallel import DispPartition
from leastereo_tpu_torch.utils.weights import state_dict_from_jax

H, W, MAXDISP = 48, 96, 48
# fp32 on both sides; convolutions and resizes sum in other orders: 2e-3 px.
TOL_PX = 2e-3


def _perturbed_state_dict(model, rng):
    sd = model.state_dict()
    for k, t in sd.items():
        n = tuple(t.shape)
        if k.endswith("bn.weight"):
            t.mul_(torch.from_numpy((1 + 0.2 * rng.randn(*n)).astype(np.float32)))
        elif k.endswith("bn.bias") or k.endswith("bn.running_mean"):
            t.add_(torch.from_numpy((0.1 * rng.randn(*n)).astype(np.float32)))
        elif k.endswith("bn.running_var"):
            t.mul_(torch.from_numpy(np.exp(0.3 * rng.randn(*n)).astype(np.float32)))
    return sd


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    right = rng.randn(1, H, W, 3).astype(np.float32)
    port = best_sceneflow_model(LEAStereoConfig(maxdisp=MAXDISP, compute_dtype="float32"), device="cpu")
    sd = _perturbed_state_dict(port, rng)
    with torch.no_grad():
        feats = port.feature(torch.from_numpy(np.concatenate([left, right])).permute(0, 3, 1, 2))
        cost = port.matching.last_3(port.matching(feats[:1], feats[1:], MAXDISP // 3))
        sd["matching.last_3.conv.weight"].mul_(3.0 / cost.std())
    port.load_state_dict(sd)

    jax_model = jax_best(JaxConfig(maxdisp=MAXDISP, compute_dtype="float32"))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, import_torch_state_dict(shapes, sd))
    return dict(port=port, sd=sd, variables=variables, left=left, right=right)


def test_state_dict_round_trips(setup):
    sd, variables = setup["sd"], setup["variables"]
    back = state_dict_from_jax(variables)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k].to(back[k].dtype)), k
    again = import_torch_state_dict(variables, back)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_feature_net_matches_jax(setup):
    port, variables, left = setup["port"], setup["variables"], setup["left"]
    feat = JaxFeatureNet(genotype=JAX_BEST["feature"], dtype=jnp.float32)
    fv = {c: variables[c]["feature"] for c in ("params", "batch_stats")}
    ref = np.asarray(feat.apply(fv, jnp.asarray(left)))
    with torch.no_grad():
        got = port.feature(torch.from_numpy(left).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (1, H // 3, W // 3, 32)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("return_entropy", [False, True])
def test_whole_model_matches_jax(setup, return_entropy):
    cfg = dict(maxdisp=MAXDISP, compute_dtype="float32", return_entropy=return_entropy)
    jax_model = jax_best(JaxConfig(**cfg))
    ref = jax.jit(jax_model.apply)(setup["variables"], setup["left"], setup["right"])
    port = best_sceneflow_model(LEAStereoConfig(**cfg), device="cpu")
    port.load_state_dict(setup["sd"])
    with torch.no_grad():
        got = port(torch.from_numpy(setup["left"]), torch.from_numpy(setup["right"]))
    if return_entropy:
        (ref, ref_ent), (got, got_ent) = ref, got
        np.testing.assert_allclose(got_ent.numpy(), np.asarray(ref_ent), rtol=1e-4, atol=1e-6)
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == (1, H, W) and np.isfinite(got).all()
    assert ref.std() > 1.0  # the cost is informative, not flat
    assert np.abs(got - ref).max() < TOL_PX


def test_explicit_volume_stem_matches_jax(setup):
    """``fused_stem=False``: the explicit cost volume through stem0's ConvBR."""
    cfg = dict(maxdisp=MAXDISP, compute_dtype="float32", fused_stem=False)
    ref = jax.jit(jax_best(JaxConfig(**cfg)).apply)(setup["variables"], setup["left"], setup["right"])
    port = best_sceneflow_model(LEAStereoConfig(**cfg), device="cpu")
    port.load_state_dict(setup["sd"])
    with torch.no_grad():
        got = port(torch.from_numpy(setup["left"]), torch.from_numpy(setup["right"])).numpy()
    assert got.shape == (1, H, W) and np.isfinite(got).all()
    assert np.abs(got - np.asarray(ref)).max() < TOL_PX


def test_refused_heads_route_to_band_kernel_wrapper(setup, monkeypatch, caplog):
    """With the fused head's gate refusing, the model still calls the band kernel's
    wrapper (which raises for a CUDA cost) and never the plain soft-argmin
    itself; the fused-head refusal is logged once."""
    import leastereo_tpu_torch.models.leastereo as lst
    from leastereo_tpu_torch.ops import _build

    left, right = torch.from_numpy(setup["left"]), torch.from_numpy(setup["right"])
    with torch.no_grad():
        ref = setup["port"](left, right)

    def no_plain(*args, **kwargs):
        raise AssertionError("the model ran the plain soft_argmin")

    calls, band = [], lst.soft_argmin_fused

    def spy(cost, maxdisp):
        calls.append(tuple(cost.shape))
        return band(cost, maxdisp)

    monkeypatch.setattr(_build, "SMEM_LIMIT", 0)
    monkeypatch.setattr(lst, "soft_argmin", no_plain)
    monkeypatch.setattr(lst, "soft_argmin_fused", spy)
    port = best_sceneflow_model(LEAStereoConfig(maxdisp=MAXDISP, compute_dtype="float32"), device="cpu")
    port.load_state_dict(setup["sd"])
    with torch.no_grad(), caplog.at_level("WARNING", logger=lst.__name__):
        got = port(left, right)
        port(left, right)
    assert calls == [(1, MAXDISP // 3, H // 3, W // 3)] * 2
    assert [r.getMessage() for r in caplog.records if "fused head disabled" in r.getMessage()] == [
        "fused head disabled: " + lst.fused_head_sm90_gate_reason(32, MAXDISP // 3, MAXDISP, torch.float32)
    ]
    assert torch.allclose(got, ref, atol=1e-4)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        best_sceneflow_model(LEAStereoConfig(maxdisp=MAXDISP))


def test_port_imports_no_jax():
    code = (
        "import sys, leastereo_tpu_torch, leastereo_tpu_torch.utils.weights;"
        "import leastereo_tpu_torch.ops.fused_stem, leastereo_tpu_torch.ops._build;"
        "import leastereo_tpu_torch.train, leastereo_tpu_torch.data.pipeline, leastereo_tpu_torch.utils.experiment;"
        "import leastereo_tpu_torch.utils.checkpoint, leastereo_tpu_torch.search;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'leastereo_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=repo)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# The matching net's eval volumes NDHWC against NCDHW: BEST_SCENEFLOW's path
# (both benchmark configurations') at even, odd and mixed (D, h, w), and a
# path to level 3 (the last_24 and last_12 heads too), without skips.
_DEEP = Architecture((1, 2, 3, 3, 2, 3), BEST_SCENEFLOW["matching"].cell_genotype)
MATCHING_CASES = [(BEST_SCENEFLOW["matching"], DEFAULT_SKIPS, (16, 16, 32)),
                  (BEST_SCENEFLOW["matching"], DEFAULT_SKIPS, (9, 7, 17)),
                  (BEST_SCENEFLOW["matching"], DEFAULT_SKIPS, (17, 10, 15)),
                  (_DEEP, (), (16, 17, 12))]


def _matching_net(arch, skips, seed=0):
    """A matching net in eval mode whose BN statistics and affines are off their init."""
    net = MatchingNet(arch, 32, skips=skips, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm3d):
            c = m.num_features
            m.weight.data.mul_(1 + 0.2 * torch.randn(c, generator=gen))
            m.bias.data.add_(0.1 * torch.randn(c, generator=gen))
            m.running_mean.add_(0.1 * torch.randn(c, generator=gen))
            m.running_var.mul_(torch.exp(0.3 * torch.randn(c, generator=gen)))
    return net.eval()


def _route_delta(before):
    return {k: v - before[k] for k, v in ConvBR.eval_routes.items()}


@pytest.mark.parametrize("arch,skips,dhw", MATCHING_CASES)
def test_ndhwc_matching_net_matches_ncdhw(monkeypatch, arch, skips, dhw):
    """The eval forward runs every 3-D ConvBR on NDHWC volumes and returns an
    NCDHW volume equal, in float32, to the forward that keeps NCDHW throughout
    (``layout`` forced), which runs as many convolutions, all NCDHW."""
    d, h, w = dhw
    net = _matching_net(arch, skips)
    rng = np.random.RandomState(9)
    left, right = (torch.from_numpy(rng.randn(1, 32, h, w).astype(np.float32)) for _ in range(2))
    before = dict(ConvBR.eval_routes)
    with torch.no_grad():
        got = net(left, right, d)
        ndhwc = _route_delta(before)
        before = dict(ConvBR.eval_routes)
        monkeypatch.setattr(MatchingNet, "layout", lambda self, part: torch.contiguous_format)
        want = net(left, right, d)
        ncdhw = _route_delta(before)
    assert ndhwc["ndhwc"] > 0 and ndhwc == {"ndhwc_sm90": 0, "ndhwc_fused": 0, "ndhwc": ndhwc["ndhwc"], "ncdhw": 0}
    assert ncdhw == {"ndhwc_sm90": 0, "ndhwc_fused": 0, "ndhwc": 0, "ncdhw": ndhwc["ndhwc"]}
    assert got.shape == want.shape == (1, 32, d, h, w) and got.is_contiguous()
    # fp32, the same algebra; the CPU's NDHWC convolutions sum in another order.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("mode", ["train", "sharded"])
def test_training_and_sharded_forwards_stay_ncdhw(mode):
    """Training and a forward on a slab (a one-shard partition here) never see
    an NDHWC volume: no 3-D ConvBR input is NDHWC, and the route counter
    counts no NDHWC call (training: no eval call at all)."""
    d, h, w = 9, 7, 17
    net = _matching_net(BEST_SCENEFLOW["matching"], DEFAULT_SKIPS).train(mode == "train")
    rng = np.random.RandomState(10)
    left, right = (torch.from_numpy(rng.randn(1, 32, h, w).astype(np.float32)) for _ in range(2))
    inputs = []
    hooks = [m.register_forward_pre_hook(lambda _, args: inputs.append(args[0]))
             for m in net.modules() if isinstance(m, ConvBR)]
    before = dict(ConvBR.eval_routes)
    with torch.no_grad():
        out = net(left, right, d, part=None if mode == "train" else DispPartition(d))
    for hk in hooks:
        hk.remove()
    delta = _route_delta(before)
    assert inputs and not any(is_ndhwc(x) for x in inputs)
    assert out.is_contiguous() and out.shape == (1, 32, d, h, w)
    assert delta["ndhwc"] == delta["ndhwc_fused"] == delta["ndhwc_sm90"] == 0
    assert (delta["ncdhw"] == 0) if mode == "train" else (delta["ncdhw"] > 0)
