"""The port's profiling, tracing and classic-evaluator utilities
(``leastereo_tpu_torch/utils/{profiling,tracing,classic_eval}.py``) on the
CPU, against the JAX package's where both count the same thing."""

import json

import jax
import numpy as np
import pytest
import torch

from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.utils import (
    cost_analysis,
    count_params,
    midd_eval_average,
    midd_eval_sample,
    model_flops,
    param_size_mb,
)
from leastereo_tpu_torch.utils.profiling import device_peak_hbm_gb, peak_hbm_gb
from leastereo_tpu_torch.utils.tracing import trace


def test_count_params_matches_jax():
    """The port's model and the JAX model of the same architecture (48x96,
    maxdisp 48) hold the same number of parameters: 1,724,912."""
    from leastereo_tpu.models import LEAStereoConfig as JaxConfig
    from leastereo_tpu.models import best_sceneflow_model as jax_best
    from leastereo_tpu.utils import count_params as jax_count_params
    from leastereo_tpu.utils import param_size_mb as jax_param_size_mb

    sample = jax.ShapeDtypeStruct((1, 48, 96, 3), np.float32)
    shapes = jax.eval_shape(jax_best(JaxConfig(maxdisp=48, compute_dtype="float32")).init,
                            jax.random.PRNGKey(0), sample, sample)
    port = best_sceneflow_model(LEAStereoConfig(maxdisp=48, compute_dtype="float32"), device="cpu")
    assert count_params(port) == jax_count_params(shapes["params"]) == 1_724_912
    assert param_size_mb(port) == jax_param_size_mb(shapes["params"]) == 1.724912


def test_param_size_mb_counts_millions():
    layer = torch.nn.Linear(128, 64)
    assert count_params(layer) == 128 * 64 + 64
    assert abs(param_size_mb(layer) - (128 * 64 + 64) / 1e6) < 1e-12


def test_cost_analysis_counts_a_matmul():
    """As tests/test_utils.py holds the JAX one: at least 2 * 8 * 64 * 32."""
    w = torch.zeros(64, 32)
    analysis = cost_analysis(lambda x: x @ w, torch.zeros(8, 64))
    assert analysis["flops"] >= 2 * 8 * 64 * 32
    assert model_flops(lambda x: x @ w, torch.zeros(8, 64)) == analysis["flops"]


def test_memory_readers_return_none_on_cpu():
    assert peak_hbm_gb("cpu") is None
    if not torch.cuda.is_available():
        assert device_peak_hbm_gb() is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_midd_eval_needs_its_binary(tmp_path):
    with pytest.raises(FileNotFoundError, match="midd_eval"):
        midd_eval_sample(str(tmp_path / "pred.pfm"), str(tmp_path / "gt.pfm"), binary="midd_eval_not_installed")
    with pytest.raises(FileNotFoundError):
        midd_eval_average([(str(tmp_path / "p"), str(tmp_path / "g"))], binary="midd_eval_not_installed")
    assert midd_eval_average([], binary="midd_eval_not_installed") == {"d_err": 0.0, "t_err": 0.0, "mean_err": 0.0}
