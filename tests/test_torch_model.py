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
