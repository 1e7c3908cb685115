"""The port's search and decode drivers (leastereo_tpu_torch/cli/search.py,
cli/decode.py) end to end on the CPU, on the bundled ``sceneflow_part``
frames (2 ``search_weights``, 2 ``search_arch``, 1 ``val``) at 48x96,
maxdisp 48, 3-layer filter-2 block-2 step-2 nets, batch 2, 2 epochs, arch
steps from epoch 1; the decoded files against JAX ``decode_arch`` on the
checkpoint's alphas and betas.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from leastereo_tpu.models.genotypes import load_architecture as jax_load_architecture
from leastereo_tpu.search import decode_arch as jax_decode_arch
from leastereo_tpu_torch import LEAStereo, LEAStereoConfig
from leastereo_tpu_torch.cli import decode, search
from leastereo_tpu_torch.cli.search import build_supernet
from leastereo_tpu_torch.cli.config import search_parser
from leastereo_tpu_torch.models.genotypes import load_architecture
from leastereo_tpu_torch.utils.checkpoint import latest_checkpoint
from test_torch_search import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parents[1]
MAXDISP, H, W, STEPS = 48, 48, 96, 2
ARGS = [
    "--dataset", "sceneflow_part", "--data_root", str(REPO / "dataset" / "sceneflow_part"),
    "--listset", "sceneflow_part", "--lists_dir", str(REPO / "dataloaders" / "lists"),
    "--crop_height", str(H), "--crop_width", str(W), "--maxdisp", str(MAXDISP), "--dtype", "float32",
    "--fea_num_layers", "3", "--mat_num_layers", "3", "--fea_filter_multiplier", "2", "--mat_filter_multiplier", "2",
    "--fea_block_multiplier", "2", "--mat_block_multiplier", "2", "--fea_step", str(STEPS), "--mat_step", str(STEPS),
    "--batch_size", "2", "--alpha_epoch", "1", "--workers", "2", "--seed", "7",
]
ARCH = ("feature.alphas", "feature.betas", "matching.alphas", "matching.betas")


def _ckpt(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)["state_dict"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("search")
    argv = ARGS + ["--device", "cpu", "--epochs", "2", "--run_root", str(root), "--experiment", "smoke"]
    assert search.main(argv) == 0
    return root / "sceneflow_part-search" / "smoke", argv


def test_search_driver_end_to_end(run):
    """Files, logs and checkpoints; the arch parameters stay at their
    initial values through epoch 0 (before ``--alpha_epoch``) and move in
    epoch 1, the weights move in both."""
    exp, argv = run
    params = json.loads((exp / "parameters.json").read_text())
    assert params["device"] == "cpu" and params["alpha_epoch"] == 1
    lines = [json.loads(ln) for ln in (exp / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["step"] == 1 and all(np.isfinite(lines[0][k]) for k in ("loss", "epe", "err3"))
    assert [ln["epoch"] for ln in lines if "val_err3" in ln] == [0, 1]
    ckpts = exp / "checkpoints"
    assert sorted(p.name for p in (ckpts / "latest").iterdir()) == ["0.pth", "1.pth"]
    assert (ckpts / "best" / "0.pth").is_file()
    init = build_supernet(search_parser().parse_args(argv)).state_dict()
    e0, e1 = _ckpt(ckpts / "latest" / "0.pth"), _ckpt(ckpts / "latest" / "1.pth")
    assert set(e0) == set(init)
    for k in ARCH:
        assert torch.equal(e0[k], init[k]), k
        assert not torch.equal(e1[k], e0[k]), k
    for k in ("feature.stem0.conv.weight", "matching.last_3.conv.weight"):
        assert not torch.equal(e0[k], init[k]) and not torch.equal(e1[k], e0[k]), k


def test_decode_driver_matches_jax(run, tmp_path):
    """``cli.decode`` on ``best`` writes the four files JAX ``decode_arch``
    gives for the checkpoint's alphas and betas; both packages' loaders read
    them into equal architectures, which build and run the port's model."""
    exp, _ = run
    best = exp / "checkpoints" / "best"
    assert decode.main(["--checkpoint", str(best), "--fea_step", str(STEPS), "--mat_step", str(STEPS)]) == 0
    out = best / "architecture"
    last = pathlib.Path(latest_checkpoint(str(best)))  # the epoch decode reads
    sd = _ckpt(last)
    nets = {}
    for net in ("feature", "matching"):
        path, _, gene = jax_decode_arch(sd[f"{net}.alphas"].numpy(), sd[f"{net}.betas"].numpy(), steps=STEPS)
        files = (out / f"{net}_network_path.npy", out / f"{net}_genotype.npy")
        np.testing.assert_array_equal(np.load(files[0]), path)
        np.testing.assert_array_equal(np.load(files[1]), gene)
        assert np.load(files[0]).dtype == path.dtype and np.load(files[1]).dtype == gene.dtype
        arch, jax_arch = load_architecture(*files), jax_load_architecture(*files)
        assert (arch.network_path, arch.cell_genotype) == (jax_arch.network_path, jax_arch.cell_genotype)
        nets[net] = arch
    cfg = LEAStereoConfig(maxdisp=MAXDISP, fea_filter_multiplier=2, fea_block_multiplier=2, fea_steps=STEPS,
                          mat_filter_multiplier=2, mat_block_multiplier=2, mat_steps=STEPS, compute_dtype="float32")
    model = LEAStereo(nets["feature"], nets["matching"], cfg, torch.Generator().manual_seed(0)).eval()
    x = torch.randn(1, H, W, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        disp = model(x, x)
    assert disp.shape == (1, H, W) and torch.isfinite(disp).all()

    # A checkpoint file, an epoch (--step) and --out_dir give the same files.
    for extra in (["--checkpoint", str(last)], ["--checkpoint", str(best), "--step", last.stem]):
        dest = tmp_path / extra[-1].replace("/", "_")
        assert decode.main(extra + ["--fea_step", str(STEPS), "--mat_step", str(STEPS), "--out_dir", str(dest)]) == 0
        for f in out.iterdir():
            assert (dest / f.name).read_bytes() == f.read_bytes(), f.name
    with pytest.raises(FileNotFoundError):
        decode.main(["--checkpoint", str(best), "--step", "7"])


def test_search_driver_resumes(run, tmp_path):
    """``--resume`` of the ``latest`` directory adopts its last epoch: with
    arch steps not yet due, the resumed run keeps that epoch's alphas and
    betas."""
    exp, _ = run
    latest = exp / "checkpoints" / "latest"
    argv = ARGS + ["--device", "cpu", "--epochs", "1", "--alpha_epoch", "1", "--run_root", str(tmp_path),
                   "--experiment", "resumed", "--resume", str(latest)]
    assert search.main(argv) == 0
    got = _ckpt(tmp_path / "sceneflow_part-search" / "resumed" / "checkpoints" / "latest" / "0.pth")
    want = _ckpt(latest / "1.pth")
    for k in ARCH:
        assert torch.equal(got[k], want[k]), k


def test_search_driver_needs_cuda_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        search.main(ARGS + ["--epochs", "1", "--run_root", str(tmp_path), "--experiment", "nocuda"])
    assert not any(tmp_path.iterdir())
