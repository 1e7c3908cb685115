"""The port's training driver (leastereo_tpu_torch/cli/train.py) end to end on
the CPU, and against the JAX package's driver.

Both run ``main(argv)`` on the synthetic SceneFlow tree and tiny
architecture of ``tests/test_cli.py`` (24x48 crop, maxdisp 24, float32):
a 2-epoch run, a resumed run with freezing, warmup and a ``--val_other``
sweep, and the first logged loss of both drivers resumed from the same
weights (an orbax checkpoint for JAX, a torch file for the port).
"""

import json

import numpy as np
import pytest
import torch

from leastereo_tpu_torch.cli import evaluate, train
from test_cli import _data_args, _model_args, workspace  # noqa: F401  (workspace: fixture)
from test_torch_cli import weights  # noqa: F401  (fixture)

TOL_LOSS = 1e-3


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def port_run(workspace):  # noqa: F811
    root, _, _ = workspace
    run_root = root / "port_train"
    argv = _model_args(root) + _data_args(root) + [
        "--device", "cpu", "--batch_size", "4", "--test_batch_size", "2", "--epochs", "2",
        "--experiment", "smoke", "--run_root", str(run_root), "--ckpt_period", "1",
    ]
    assert train.main(argv) == 0
    return run_root / "sceneflow-train" / "smoke"


def test_train_driver_end_to_end(port_run):
    exp = port_run
    params = json.loads((exp / "parameters.json").read_text())
    assert params["epochs"] == 2 and params["device"] == "cpu"
    lines = _lines(exp / "logs" / "metrics.jsonl")
    assert lines[0]["step"] == 1 and np.isfinite(lines[0]["loss"])
    assert [l["epoch"] for l in lines if "val_epe" in l] == [0, 1]
    ckpts = exp / "checkpoints"
    assert sorted(p.name for p in (ckpts / "final").iterdir()) == ["2.pth"]
    assert (ckpts / "best" / "1.pth").is_file()
    assert sorted(p.name for p in (ckpts / "periodic").iterdir()) == ["1.pth", "2.pth"]


def test_train_driver_freeze_and_resume(workspace, port_run, tmp_path):  # noqa: F811
    """Resume from the run's final checkpoint directory (its latest epoch)
    with the feature net and the first two matching cells frozen: those
    parameters keep the resumed values, the rest move; the frozen layers'
    BN statistics still update. The result loads into ``evaluate``."""
    root, _, _ = workspace
    prev = port_run / "checkpoints" / "final"
    run_root = tmp_path / "resumed"
    argv = _model_args(root) + _data_args(root) + [
        "--device", "cpu", "--batch_size", "2", "--epochs", "1", "--experiment", "resume_smoke",
        "--run_root", str(run_root), "--resume", str(prev), "--freeze_feature", "1", "--freeze_matching", "2",
        "--lr_scheduler", "poly", "--warmup_epochs", "1",
        "--val_other", f"tagil_like:sceneflow:{root / 'lists' / 'demo' / 'val.list'}:{root / 'data'}:1.5",
    ]
    assert train.main(argv) == 0
    exp = run_root / "sceneflow-train" / "resume_smoke"
    lines = _lines(exp / "logs" / "metrics.jsonl")
    assert any("val_tagil_like_epe" in l for l in lines) and any("val_epe" in l for l in lines)

    before = torch.load(prev / "2.pth", weights_only=True)["state_dict"]
    after = torch.load(exp / "checkpoints" / "final" / "1.pth", weights_only=True)["state_dict"]
    frozen = [k for k in before if k.startswith(("feature.", "matching.stem", "matching.cells.0.", "matching.cells.1."))
              and k.endswith(("conv.weight", "bn.weight", "bn.bias"))]
    assert frozen and all(torch.equal(before[k], after[k]) for k in frozen)
    # Warmup gives update 0 lr 0 and the epoch has 2 updates: the second moves the rest.
    assert not torch.equal(before["matching.last_3.conv.weight"], after["matching.last_3.conv.weight"])
    assert not torch.equal(before["feature.stem0.bn.running_mean"], after["feature.stem0.bn.running_mean"])

    out = tmp_path / "eval"
    eval_argv = _model_args(root) + _data_args(root) + [
        "--device", "cpu", "--split", "test", "--checkpoint", str(exp / "checkpoints" / "final" / "1.pth"),
        "--output_dir", str(out)]
    assert evaluate.main(eval_argv) == 0
    assert len(list(out.glob("*_pred.npy"))) == 2


def test_train_driver_matches_jax(workspace, weights, tmp_path):  # noqa: F811
    """One resumed step of each driver from the same weights: the first
    logged loss agrees."""
    from leastereo_tpu.cli.train import main as jax_main

    root, orbax_dir, pth = weights
    common = _model_args(root) + _data_args(root) + [
        "--batch_size", "2", "--epochs", "1", "--max_steps_per_epoch", "1", "--workers", "0",
        "--experiment", "one_step", "--seed", "5",
    ]
    assert jax_main(common + ["--run_root", str(tmp_path / "jax"), "--resume", orbax_dir, "--mesh_data", "1"]) == 0
    assert train.main(common + ["--run_root", str(tmp_path / "port"), "--resume", pth, "--device", "cpu"]) == 0
    first = [_lines(tmp_path / side / "sceneflow-train" / "one_step" / "logs" / "metrics.jsonl")[0]
             for side in ("jax", "port")]
    assert first[0]["step"] == first[1]["step"] == 1
    assert np.isfinite(first[1]["loss"]) and first[1]["loss"] > 0
    np.testing.assert_allclose(first[1]["loss"], first[0]["loss"], rtol=TOL_LOSS)


def test_train_driver_defaults_to_cuda(workspace, monkeypatch, tmp_path):  # noqa: F811
    root, _, _ = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(_model_args(root) + _data_args(root) + ["--run_root", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


def test_resume_without_checkpoint_raises(workspace, tmp_path):  # noqa: F811
    root, _, _ = workspace
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        train.main(_model_args(root) + _data_args(root) + [
            "--device", "cpu", "--run_root", str(tmp_path / "r"), "--resume", str(tmp_path / "empty")])
