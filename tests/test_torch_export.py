"""The port's export entry point (``leastereo_tpu_torch/cli/export.py``)
against the JAX package's (``leastereo_tpu/cli/export.py``), on the CPU.

Setting: the 48x96, maxdisp 48, fp32 model, with the JAX model's ``init``
weights carried into the port through ``utils/weights.py``
``state_dict_from_jax`` (the ``last_3`` kernel scaled so the cost spans a few
units, as ``tests/test_torch_cli.py`` does). The exported graph must carry
the fused head as ``leastereo.conv_soft_argmin``, with no ``aten`` conv on the
``last_3`` weight; the saved and loaded ``.pt2`` must equal the eager model
and agree with JAX's deserialized StableHLO program within 1e-3 px (the
model's own parity is ~4.8e-5 px).
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.cli import export
from leastereo_tpu_torch.utils.weights import state_dict_from_jax

H, W, MAXDISP = 48, 96, 48
TOL_JAX_PX = 1e-3
LAST_3 = "matching.last_3.conv.weight"
# Single-input nodes a weight passes through on its way to its consumer.
_PASS_THROUGH = ("aten.to.", "aten._to_copy.", "aten.alias.", "aten.detach.")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from leastereo_tpu.cli.export import export_stablehlo
    from leastereo_tpu.models import LEAStereoConfig as JaxConfig
    from leastereo_tpu.models import best_sceneflow_model as jax_best

    jax_model = jax_best(JaxConfig(maxdisp=MAXDISP, compute_dtype="float32"))
    sample = np.zeros((1, H, W, 3), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jax_model.init)(jax.random.PRNGKey(0), sample, sample)))
    rng = np.random.RandomState(0)
    left, right = (rng.randn(1, H, W, 3).astype(np.float32) for _ in range(2))
    port = best_sceneflow_model(LEAStereoConfig(maxdisp=MAXDISP, compute_dtype="float32"), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        feats = port.feature(torch.from_numpy(np.concatenate([left, right])).permute(0, 3, 1, 2))
        cost = port.matching.last_3(port.matching(feats[:1], feats[1:], MAXDISP // 3))
    last_3 = variables["params"]["matching"]["last_3"]["conv"]
    last_3["kernel"] = last_3["kernel"] * np.float32(3.0 / cost.std().item())
    sd = state_dict_from_jax(variables)
    port.load_state_dict(sd)
    tmp = tmp_path_factory.mktemp("export")
    torch.save(sd, tmp / "weights.pth")
    blob, _ = export_stablehlo(jax_model, variables, H, W)
    # The driver exports, saves, loads and checks the round trip itself.
    out = tmp / "model.pt2"
    argv = ["--device", "cpu", "--dtype", "float32", "--maxdisp", str(MAXDISP), "--height", str(H),
            "--width", str(W), "--checkpoint", str(tmp / "weights.pth"), "--out", str(out)]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = export.main(argv)
    program = torch.export.load(out)
    return {"port": port, "program": program, "loaded": program.module(), "pt2": out, "rc": rc,
            "printed": printed.getvalue(), "stablehlo": blob, "left": left, "right": right}


def _source(node):
    while node.op == "call_function" and str(node.target).startswith(_PASS_THROUGH):
        node = node.args[0]
    return node


def test_graph_carries_the_fused_head_op(setup):
    program = setup["program"]
    params = {name: fqn for name, fqn in program.graph_signature.inputs_to_parameters.items()}
    calls = [n for n in program.graph.nodes if n.op == "call_function"]
    heads = [n for n in calls if str(n.target) == "leastereo.conv_soft_argmin.default"]
    assert len(heads) == 1
    assert params.get(_source(heads[0].args[1]).name) == LAST_3
    convs = [n for n in calls if str(n.target).startswith(("aten.conv3d.", "aten.convolution."))]
    # The matching net's own 3-D convolutions stay aten convs; none takes last_3.
    assert len(convs) > 10
    assert not [n for n in convs if params.get(_source(n.args[1]).name) == LAST_3]


def test_export_driver_round_trip(setup):
    out = setup["pt2"]
    assert setup["rc"] == 0 and out.is_file()
    assert setup["printed"].strip().splitlines()[-1] == (
        f"exported .pt2 to {out} ({out.stat().st_size} bytes); round-trip check passed")


def test_pt2_round_trip_equals_eager(setup):
    left, right = torch.from_numpy(setup["left"]), torch.from_numpy(setup["right"])
    with torch.no_grad():
        want = setup["port"](left, right)
        got = setup["loaded"](left, right)
    assert got.shape == (1, H, W)
    assert torch.equal(got, want)


def test_pt2_matches_jax_stablehlo(setup):
    from jax import export as jax_export

    want = np.asarray(jax_export.deserialize(setup["stablehlo"]).call(setup["left"], setup["right"]))
    with torch.no_grad():
        got = setup["loaded"](torch.from_numpy(setup["left"]), torch.from_numpy(setup["right"])).numpy()
    assert got.shape == want.shape == (1, H, W)
    assert want.std() > 0.1
    assert np.abs(got - want).max() < TOL_JAX_PX


@pytest.mark.parametrize("fmt", ["stablehlo", "savedmodel"])
def test_export_format_other_than_pt2_is_refused(tmp_path, fmt):
    with pytest.raises(SystemExit) as exc:
        export.main(["--device", "cpu", "--out", str(tmp_path / "x"), "--format", fmt])
    assert exc.value.code == 2


def test_export_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.main(["--out", str(tmp_path / "x.pt2")])
