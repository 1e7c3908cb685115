"""The port's drivers with the mesh flags, on the CPU (gloo): the driver
spawns its own ranks as local processes (``cli/common.py`` ``run_on_mesh``).
On the synthetic SceneFlow tree and tiny architecture of
``tests/test_cli.py`` (24x48 crop, maxdisp 24, float32):

* ``cli.predict --mesh_disp 2`` writes the disparity of the one-process run;
* ``cli.evaluate --mesh_data 2`` splits the frames and prints the averages
  of the one-process run, with the same files;
* ``cli.train --mesh_data 2`` spawns its ranks, takes 2 steps and only rank
  0 writes checkpoints and logs; ``--multihost`` under torchrun's variables
  for a world of one joins and leaves a gloo group;
* ``cli.train --mesh_disp 2`` trains disparity-sharded and ``cli.search
  --mesh_disp 2`` replicates over the disp ranks: each runs to its end, its
  first loss that of the ``--mesh_disp 1`` run;
* what the drivers refuse: on ``cuda`` a mesh larger than the cards.
"""

import json
import os

import numpy as np
import pytest
import torch

from leastereo_tpu_torch.cli import evaluate, predict, search, train
from leastereo_tpu_torch.cli.common import build_model
from leastereo_tpu_torch.cli.config import predict_parser
from leastereo_tpu_torch.utils.checkpoint import load_state_dict_file
from test_cli import CROP_H, CROP_W, MAXDISP, _data_args, _model_args, workspace  # noqa: F401  (workspace: fixture)

TOL_PX = 1e-4  # the sharded head sums in another order
TOL_SAME = 1e-5  # one model, one frame, ranks on one intra-op thread against the test's process


@pytest.fixture(scope="module")
def checkpoint(workspace):  # noqa: F811
    """The tiny model's seeded weights with the last_3 kernel scaled so the
    cost spans a few units (as tests/test_torch_cli.py), as a torch file."""
    root, _, _ = workspace
    model = build_model(predict_parser().parse_args(_model_args(root) + _data_args(root) + ["--device", "cpu"]))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, CROP_H, CROP_W, 3).astype(np.float32))
    with torch.no_grad():
        feats = model.feature(x.permute(0, 3, 1, 2))
        cost = model.matching.last_3(model.matching(feats[:1], feats[1:], MAXDISP // 3))
        model.matching.last_3.conv.weight.mul_(3.0 / cost.std())
    path = root / "parallel_weights.pth"
    torch.save(model.state_dict(), path)
    return path


@pytest.fixture(autouse=True)
def one_thread_ranks(monkeypatch):
    """The ranks and the test's own process on one intra-op thread. Beside
    other test workers (pytest-xdist) a pool of one thread a core
    oversubscribes the cores: the in-process one-rank search run of
    ``test_search_driver_replicates_over_disp`` then took over ten times as
    long as alone."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(d):
    return {p.name: np.load(p) for p in sorted(d.glob("*.npy"))}


def test_predict_disparity_sharded_matches_one_process(workspace, checkpoint, tmp_path):  # noqa: F811
    root, _, _ = workspace
    base = _model_args(root) + _data_args(root) + ["--device", "cpu", "--checkpoint", str(checkpoint),
                                                    "--confidence"]
    assert predict.main(base + ["--output_dir", str(tmp_path / "one")]) == 0
    assert predict.main(base + ["--mesh_disp", "2", "--output_dir", str(tmp_path / "two")]) == 0
    one, two = _arrays(tmp_path / "one"), _arrays(tmp_path / "two")
    assert one.keys() == two.keys() and len(one) == 4  # 2 frames: disparity and confidence
    assert sorted(os.listdir(tmp_path / "one")) == sorted(os.listdir(tmp_path / "two"))
    for name in one:
        assert one[name].std() > 0
        np.testing.assert_allclose(two[name], one[name], rtol=TOL_PX, atol=TOL_PX, err_msg=name)


def test_evaluate_data_parallel_matches_one_process(workspace, checkpoint, tmp_path, capfd):  # noqa: F811
    root, _, _ = workspace
    base = _model_args(root) + _data_args(root) + ["--device", "cpu", "--checkpoint", str(checkpoint),
                                                    "--split", "train"]

    def averages(out: str) -> list[str]:
        lines = out.splitlines()
        return lines[lines.index("=== averages ===") :]

    assert evaluate.main(base + ["--output_dir", str(tmp_path / "one")]) == 0
    want = averages(capfd.readouterr().out)
    assert evaluate.main(base + ["--mesh_data", "2", "--output_dir", str(tmp_path / "two")]) == 0
    out = capfd.readouterr().out
    assert out.count("=== averages ===") == 1  # rank 0 alone prints them
    one, two = _arrays(tmp_path / "one"), _arrays(tmp_path / "two")
    assert len(one) == 4 and sorted(os.listdir(tmp_path / "one")) == sorted(os.listdir(tmp_path / "two"))
    for name in one:
        np.testing.assert_allclose(two[name], one[name], rtol=TOL_SAME, atol=TOL_SAME, err_msg=name)
    assert averages(out) == want


def test_train_data_parallel_driver(workspace, tmp_path):  # noqa: F811
    root, _, _ = workspace
    argv = _model_args(root) + _data_args(root) + [
        "--device", "cpu", "--mesh_data", "2", "--batch_size", "4", "--test_batch_size", "1", "--epochs", "2",
        "--loop_mode", "n_epochs", "--ckpt_period", "0", "--experiment", "dp", "--run_root", str(tmp_path),
    ]
    assert train.main(argv) == 0
    exp = tmp_path / "sceneflow-train" / "dp"
    lines = [json.loads(line) for line in (exp / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = [line for line in lines if "loss" in line]
    assert [line["step"] for line in steps] == [1] and np.isfinite(steps[0]["loss"])  # logged once, by rank 0
    assert [line["epoch"] for line in lines if "val_epe" in line] == [0, 1]
    ckpts = exp / "checkpoints"
    assert sorted(p.relative_to(ckpts).as_posix() for p in ckpts.rglob("*.pth"))[-1] == "final/2.pth"
    model = build_model(predict_parser().parse_args(_model_args(root) + _data_args(root) + ["--device", "cpu"]))
    load_state_dict_file(str(ckpts / "final" / "2.pth"), model)
    assert int(model.matching.stem1.bn.num_batches_tracked) == 2  # two steps


def test_train_under_a_launcher_world_of_one(workspace, tmp_path, monkeypatch):  # noqa: F811
    """``--multihost`` with torchrun's variables for a world of one: the
    driver joins a gloo group, its data axis reduces over it (sync-BN, the
    gradients and the metrics go through all_reduce), and it leaves the group."""
    import socket

    import torch.distributed as dist

    root, _, _ = workspace
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(dist, "all_reduce", lambda *a, _f=dist.all_reduce, **k: calls.append(1) or _f(*a, **k))
    argv = _model_args(root) + _data_args(root) + [
        "--device", "cpu", "--multihost", "--batch_size", "4", "--epochs", "1", "--loop_mode", "n_epochs",
        "--ckpt_period", "0", "--experiment", "launched", "--run_root", str(tmp_path),
    ]
    assert train.main(argv) == 0
    assert not dist.is_initialized()
    assert len(calls) > 10  # BN statistics of every layer, the count, the gradients, the metrics
    assert (tmp_path / "sceneflow-train" / "launched" / "checkpoints" / "final" / "1.pth").is_file()


def _log(exp) -> list[dict]:
    return [json.loads(line) for line in (exp / "logs" / "metrics.jsonl").read_text().splitlines()]


def test_disparity_sharded_train_driver(workspace, tmp_path):  # noqa: F811
    """``train --mesh_disp 2``: the two ranks share each step's volume; the
    first loss is the one-process run's; both epochs validate, which the
    sharded forward of rank 0 can only do with rank 1 beside it (its
    collectives span the disp ranks), to the one-process run's averages;
    rank 0 writes the checkpoint."""
    root, _, _ = workspace
    base = _model_args(root) + _data_args(root) + [
        "--device", "cpu", "--batch_size", "2", "--test_batch_size", "1", "--epochs", "2",
        "--loop_mode", "n_epochs", "--ckpt_period", "0", "--run_root", str(tmp_path),
    ]
    assert train.main(base + ["--experiment", "one"]) == 0
    assert train.main(base + ["--mesh_disp", "2", "--experiment", "disp"]) == 0
    one, two = (_log(tmp_path / "sceneflow-train" / e) for e in ("one", "disp"))
    first = [[line["loss"] for line in log if "loss" in line] for log in (one, two)]
    assert len(first[1]) == 1 and np.isfinite(first[1][0])  # logged once, by rank 0
    np.testing.assert_allclose(first[1][0], first[0][0], rtol=TOL_SAME)
    vals = [[line for line in log if "val_epe" in line] for log in (one, two)]
    assert [line["epoch"] for line in vals[1]] == [0, 1]
    np.testing.assert_allclose([v["val_epe"] for v in vals[1]], [v["val_epe"] for v in vals[0]], rtol=TOL_PX)
    ckpts = tmp_path / "sceneflow-train" / "disp" / "checkpoints"
    assert (ckpts / "final" / "2.pth").is_file()
    model = build_model(predict_parser().parse_args(_model_args(root) + _data_args(root) + ["--device", "cpu"]))
    load_state_dict_file(str(ckpts / "final" / "2.pth"), model)
    assert int(model.matching.stem1.bn.num_batches_tracked) == 4  # two epochs of two steps


def test_search_driver_replicates_over_disp(tmp_path):
    """``search --mesh_disp 2`` replicates, as the JAX driver: both ranks
    take the same steps on the same rows; the first loss is the one-process
    run's, and rank 0 validates and writes the checkpoints."""
    from test_torch_search_cli import ARGS

    base = ARGS + ["--device", "cpu", "--epochs", "2", "--run_root", str(tmp_path)]
    assert search.main(base + ["--experiment", "one"]) == 0
    assert search.main(base + ["--mesh_disp", "2", "--experiment", "disp"]) == 0
    one, two = (_log(tmp_path / "sceneflow_part-search" / e) for e in ("one", "disp"))
    first = [[line["loss"] for line in log if "loss" in line] for log in (one, two)]
    assert len(first[1]) == 1 and np.isfinite(first[1][0])
    np.testing.assert_allclose(first[1][0], first[0][0], rtol=TOL_SAME)
    assert [line["epoch"] for line in two if "val_err3" in line] == [0, 1]
    ckpts = tmp_path / "sceneflow_part-search" / "disp" / "checkpoints"
    assert {p.parent.name for p in ckpts.rglob("*.pth")} == {"best", "latest"}


def test_cuda_mesh_needs_a_card_per_rank(workspace, monkeypatch):  # noqa: F811
    root, _, _ = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards"):
        predict.main(_model_args(root) + _data_args(root) + ["--mesh_data", "2"])
