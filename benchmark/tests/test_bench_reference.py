"""The plain reference against the port on the CPU, on shared weights.

This is the one place where the reference meets the program: the runs
never compare the two except through the program's outputs."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.common import make_pairs, make_state, standardize, to_uint8
from benchmark.program import build_model
from benchmark.reference.colormap import turbo_render
from benchmark.reference.compare import leaf_gaps
from benchmark.reference.model import build_reference
from benchmark.reference.png import read_png, write_png
from benchmark.reference.train import masked_loss, reference_steps

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIGS = ROOT / "benchmark" / "configs"
# float32 on both sides: the sums run in another order, the port folds BN
# into its kernels and phase-decomposes the upsample, so a pixel's
# expectation moves by a few thousandths of a pixel (measured: 3.5e-3).
TOL_PX = 2e-2


def tiny(name: str = "leastereo_kitti15", maxdisp: int = 48, size=(48, 96)) -> dict:
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg.update(maxdisp=maxdisp, compute_dtype="float32")
    cfg["init"] = dict(cfg["init"], calibration_frame=list(size))
    return cfg


@pytest.mark.parametrize("name", ["leastereo_kitti15", "leastereo_middlebury"])
def test_configs_hold_the_shipped_genotype(name):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    arch = ROOT / "run" / "sceneflow" / "best" / "architecture"
    for net in ("feature", "matching"):
        assert cfg[net]["network_path"] == np.load(arch / f"{net}_network_path.npy").tolist()
        assert cfg[net]["cell_genotype"] == np.load(arch / f"{net}_genotype.npy").tolist()
    assert cfg["reduced"] == []


def test_state_names_are_the_ports():
    cfg = tiny()
    state = make_state(cfg, 3, "cpu")
    assert set(state) == set(build_model(cfg, state, "cpu").state_dict())


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_reference_forward_matches_port(seed):
    cfg = tiny()
    cfg["init"]["last_3_std"] = 0.03  # a sharper cost than the cells', so the map has structure at this size
    state = make_state(cfg, seed, "cpu")
    left, right, _ = make_pairs(2, 48, 96, 48, seed, 2, "cpu")
    left, right = standardize(left), standardize(right)
    with torch.no_grad():
        ref = build_reference(cfg, state, "cpu")(left, right)
        port = build_model(cfg, state, "cpu")(left, right)
    assert ref.shape == port.shape == (2, 48, 96)
    assert np.percentile(np.abs(port.numpy() - ref.numpy()), 99) < TOL_PX
    assert float((port - ref).abs().max()) < 5 * TOL_PX
    assert float(ref.std()) > 2.0  # the map is not flat


def test_reference_train_step_matches_port():
    from leastereo_tpu_torch.train.losses import masked_smooth_l1
    from leastereo_tpu_torch.train.step import make_optimizer, train_step

    cfg = tiny()
    state = make_state(cfg, 4, "cpu")
    left, right, disp = make_pairs(2, 48, 96, 48, 4, 2, "cpu")
    left, right = standardize(left), standardize(right)
    ref = reference_steps(cfg, state, [(left, right, disp)], 1e-3, "cpu")
    model = build_model(cfg, state, "cpu", train=True)
    opt = make_optimizer(model.parameters(), "adam", 1e-3)
    out = train_step(model, opt, {"left": left.numpy(), "right": right.numpy(), "disparity": disp.numpy()}, 48, 1e-3)
    assert out["loss"] == pytest.approx(ref["losses"][0], rel=1e-4)
    grad = {k: opt.state[p]["exp_avg"] / 0.1 for k, p in model.named_parameters()}
    assert max(leaf_gaps(grad, ref["grad"], list(ref["grad"])).values()) < 0.05
    assert masked_loss(disp + 0.5, disp, 48).item() == pytest.approx(
        masked_smooth_l1(disp + 0.5, disp, 48).item(), rel=1e-6)


def test_png_round_trip_and_program_reader(tmp_path):
    from leastereo_tpu_torch.data.loaders import load_kitti2015

    left, right, disp = make_pairs(1, 30, 40, 48, 1, 2, "cpu")
    rgb = [to_uint8(v)[0].numpy() for v in (left, right)]
    d16 = (256 * disp[0]).round().to(torch.int32).numpy().astype(np.uint16)
    for sub, img in zip(("image_2", "image_3", "disp_occ_0"), (*rgb, d16)):
        (tmp_path / sub).mkdir()
        write_png(str(tmp_path / sub / "000000_10.png"), img)
        assert np.array_equal(read_png(str(tmp_path / sub / "000000_10.png")), img)
    stack = load_kitti2015(str(tmp_path), "image_2/000000_10.png")
    assert np.allclose(stack[6], d16 / 256.0)
    ref = (rgb[0] - rgb[0].mean(axis=(0, 1))) / rgb[0].std(axis=(0, 1))
    assert np.allclose(stack[0:3].transpose(1, 2, 0), ref, atol=1e-5)


def test_turbo_copy_is_the_drivers():
    from leastereo_tpu_torch.utils.colorize import colorize_disparity

    disp = np.random.default_rng(0).uniform(0, 190, (20, 30)).astype(np.float32)
    disp[0, 0] = np.nan
    assert np.array_equal(turbo_render(disp), colorize_disparity(disp))
