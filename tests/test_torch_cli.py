"""The port's predict and evaluate drivers (leastereo_tpu_torch/cli) against
the JAX package's, end to end on the CPU.

Both sides run their ``main(argv)`` on the synthetic SceneFlow tree and tiny
architecture of ``tests/test_cli.py`` (24x48 crop, maxdisp 24, float32), on
the same weights: the JAX model initialised as ``leastereo_tpu/cli/predict.py``
does, saved as an orbax checkpoint for the JAX driver and as a torch
state_dict file for the port's. fp32 on both sides; convolutions and resizes
sum in other orders, so predictions agree within 1e-3 px and the entropy
within 1e-4.
"""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from leastereo_tpu_torch.cli import evaluate, predict
from leastereo_tpu_torch.cli.common import build_model
from leastereo_tpu_torch.cli.config import predict_parser
from leastereo_tpu_torch.utils.checkpoint import load_state_dict_file
from leastereo_tpu_torch.utils.weights import state_dict_from_jax
from test_cli import CROP_H, CROP_W, MAXDISP, _data_args, _model_args, workspace  # noqa: F401  (workspace: fixture)

TOL_PX = 1e-3
TOL_ENTROPY = 1e-4
TOL_EPE = 1e-4


@pytest.fixture(scope="module")
def weights(workspace):  # noqa: F811
    """The JAX model's variables as an orbax checkpoint and a torch file."""
    from leastereo_tpu.cli.common import build_model as jax_build_model
    from leastereo_tpu.cli.config import predict_parser as jax_predict_parser
    from leastereo_tpu.utils import save_checkpoint

    root, _, _ = workspace
    args = jax_predict_parser().parse_args(_model_args(root) + _data_args(root))
    model = jax_build_model(args)
    sample = np.zeros((1, CROP_H, CROP_W, 3), np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), sample, sample)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    # Random weights give a cost of large magnitude, where softmin is a near
    # hard argmin and the soft-argmin ill conditioned: scale the last_3 kernel
    # so the cost spans a few units (as tests/test_torch_model.py does).
    port = _tiny_model(root)
    port.load_state_dict(state_dict_from_jax(variables))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, CROP_H, CROP_W, 3).astype(np.float32))
    with torch.no_grad():
        feats = port.feature(x.permute(0, 3, 1, 2))
        cost = port.matching.last_3(port.matching(feats[:1], feats[1:], MAXDISP // 3))
    last_3 = variables["params"]["matching"]["last_3"]["conv"]
    last_3["kernel"] = last_3["kernel"] * np.float32(3.0 / cost.std().item())
    orbax_dir = root / "jax_ckpt"
    save_checkpoint(str(orbax_dir), 0, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    pth = root / "weights.pth"
    torch.save(state_dict_from_jax(variables), pth)
    return root, str(orbax_dir), str(pth)


def _read_metrics(path):
    return {k: float(v) for k, v in (line.split(": ") for line in path.read_text().splitlines())}


CASES = [
    ("predict", []),
    ("predict", ["--confidence"]),
    ("evaluate", []),
    ("evaluate", ["--confidence"]),
    ("evaluate", ["--full_frame", "--crop_height", "12", "--crop_width", "24"]),
]


@pytest.mark.parametrize("driver,flags", CASES, ids=["_".join([d] + [f for f in fl if f.startswith("--")]) for d, fl in CASES])
def test_driver_matches_jax(weights, driver, flags):
    from leastereo_tpu.cli import evaluate as jax_evaluate
    from leastereo_tpu.cli import predict as jax_predict

    root, orbax_dir, pth = weights
    tag = "_".join([driver] + [f.strip("-") for f in flags])
    common = _model_args(root) + _data_args(root) + ["--split", "test"] + flags
    jax_out, port_out = root / f"jax_{tag}", root / f"port_{tag}"
    jax_main = (jax_predict if driver == "predict" else jax_evaluate).main
    port_main = (predict if driver == "predict" else evaluate).main
    assert jax_main(common + ["--checkpoint", orbax_dir, "--output_dir", str(jax_out)]) == 0
    assert port_main(common + ["--checkpoint", pth, "--output_dir", str(port_out), "--device", "cpu"]) == 0

    assert sorted(p.name for p in port_out.iterdir()) == sorted(p.name for p in jax_out.iterdir())
    pred = "" if driver == "predict" else "_pred"
    npys = sorted(f for f in port_out.glob(f"*{pred}.npy") if not f.name.endswith("_conf.npy"))
    assert len(npys) == 2
    for f in npys:
        got, ref = np.load(f), np.load(jax_out / f.name)
        assert got.shape == ref.shape == (24, 36)  # the fixture's frames, whole
        assert np.isfinite(got).all() and ref.std() > 0.1
        assert np.abs(got - ref).max() < TOL_PX, f.name
        if "--confidence" in flags:
            conf = f.name.replace(f"{pred}.npy", "_conf.npy")
            assert np.abs(np.load(port_out / conf) - np.load(jax_out / conf)).max() < TOL_ENTROPY
    for f in sorted(port_out.glob("*_metrics.txt")):
        got, ref = _read_metrics(f), _read_metrics(jax_out / f.name)
        assert got.keys() == ref.keys() and got["valid_px"] == ref["valid_px"] > 0
        assert abs(got["epe"] - ref["epe"]) < TOL_EPE
        for k in ("err3", "bad1", "bad2", "bad3"):
            assert abs(got[k] - ref[k]) <= 1 / got["valid_px"] + 1e-12, k


def test_pad_to_valid():
    assert predict.pad_to_valid(25, 49) == (36, 60)
    assert predict.pad_to_valid(24, 48) == (24, 48)


@pytest.mark.parametrize("z_shift", [0.0, 1.5])
def test_round_disp_gives_integers(weights, z_shift):
    root, _, pth = weights
    out = root / f"round_{z_shift}"
    argv = _model_args(root) + _data_args(root) + [
        "--split", "test", "--checkpoint", pth, "--output_dir", str(out), "--device", "cpu",
        "--round_disp", "--z_shift", str(z_shift),
    ]
    assert evaluate.main(argv) == 0
    for f in out.glob("*_pred.npy"):
        d = np.load(f) - z_shift
        assert np.array_equal(d, np.round(d)) and d.std() > 0


def _tiny_model(root):
    args = predict_parser().parse_args(_model_args(root) + _data_args(root) + ["--device", "cpu"])
    return build_model(args)


def test_load_state_dict_file_reference_layout(workspace, tmp_path):  # noqa: F811
    """A reference-style file: ``{"state_dict": ...}`` with ``module.``
    prefixes, an unused ``last_24`` head and no ``num_batches_tracked``."""
    root, _, _ = workspace
    model = _tiny_model(root)
    rng = np.random.RandomState(0)
    want = {k: v + torch.from_numpy(rng.randn(*v.shape).astype(np.float32)) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    sd = {"module." + k: v for k, v in want.items()}
    sd["module.matching.last_24.conv.weight"] = torch.zeros(128, 64, 1, 1, 1)
    torch.save({"epoch": 3, "state_dict": sd}, tmp_path / "ref.pth")
    load_state_dict_file(str(tmp_path / "ref.pth"), model)
    for k, v in model.state_dict().items():
        if k in want:
            assert torch.equal(v, want[k]), k

    name = "matching.last_3.conv.weight"
    torch.save({k: v for k, v in want.items() if k != name}, tmp_path / "missing.pth")
    with pytest.raises(KeyError, match=name):
        load_state_dict_file(str(tmp_path / "missing.pth"), model)
    torch.save({**want, name: want[name][:, :, :2]}, tmp_path / "shape.pth")
    with pytest.raises(ValueError, match=name):
        load_state_dict_file(str(tmp_path / "shape.pth"), model)


@pytest.mark.parametrize("driver", ["predict", "evaluate"])
def test_drivers_default_to_cuda(workspace, monkeypatch, driver):  # noqa: F811
    root, _, _ = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = (predict if driver == "predict" else evaluate).main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_model_args(root) + _data_args(root) + ["--output_dir", str(root / f"nocuda_{driver}")])


def test_crop_not_divisible_by_3_raises(workspace):  # noqa: F811
    """The model refuses a crop its stride-3 stem would round up; the driver
    does not round the crop itself."""
    root, _, _ = workspace
    argv = _model_args(root) + _data_args(root) + [
        "--crop_width", "46", "--device", "cpu", "--output_dir", str(root / "crop46")]
    with pytest.raises(ValueError, match="24x46"):
        predict.main(argv)


def test_drivers_import_no_jax():
    code = (
        "import sys, leastereo_tpu_torch.cli.predict, leastereo_tpu_torch.cli.evaluate, leastereo_tpu_torch.cli.train,"
        " leastereo_tpu_torch.cli.export, leastereo_tpu_torch.utils, leastereo_tpu_torch.utils.tracing,"
        " leastereo_tpu_torch.data.native, leastereo_tpu_torch.data.augment, leastereo_tpu_torch.data.demo,"
        " leastereo_tpu_torch.data.lists, leastereo_tpu_torch.data.tools,"
        " leastereo_tpu_torch.cli.search, leastereo_tpu_torch.cli.decode, leastereo_tpu_torch.search,"
        " leastereo_tpu_torch.utils.kernel_parity;"
        "bad = [m for m in sys.modules if m.split('.')[0].startswith(('jax', 'flax', 'orbax', 'optax'))"
        " or m.split('.')[0] == 'leastereo_tpu'];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=repo)
    assert proc.returncode == 0, proc.stdout + proc.stderr
