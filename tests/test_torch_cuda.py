"""The port's CUDA kernels against their plain versions, on the card.

Each kernel (``leastereo_tpu_torch/csrc/*.cu``) is built from source on
first use and held against its plain PyTorch version evaluated in float64 on
the same inputs, at small ragged shapes and at the KITTI head shape; the
predict driver launches its dtype's head once per frame, the train driver
the band kernel once per step. Every test skips without a CUDA card. This file imports neither JAX
nor the JAX package, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.ops.fused_head import (
    conv_soft_argmin_cuda,
    conv_soft_argmin_reference,
    conv_soft_argmin_simt,
    conv_soft_argmin_sm90,
    fused_head_route,
)
from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda, soft_argmin_fused
from leastereo_tpu_torch.ops.softargmin import soft_argmin

pytestmark = pytest.mark.cuda

# fp32 kernels against float64: the summation order and __expf differ, 2e-3 px.
TOL_PX = 2e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _peaky_cost(b, d, h, w, seed=0):
    rng = np.random.RandomState(seed)
    best = rng.randint(0, d, size=(b, 1, h, w))
    planes = np.arange(d)[None, :, None, None]
    return (0.35 * np.abs(planes - best) + 0.8 * rng.randn(b, d, h, w)).astype(np.float32)


# (b, d, h, w), cost scale. Ragged against the band kernel's 1 x 32 tile,
# odd D, Middlebury's D = 136 (maxdisp 408), D = 170, wide-span costs: 300x
# at a small shape, 10x at KITTI (at 300x and KITTI's size fp32 rounding of
# the blended cost alone moves the result by ~3e-3 px, kernel and plain
# fp32 code alike).
BAND_CASES = [((1, 8, 16, 24), 1.0), ((2, 16, 20, 40), 1.0), ((1, 64, 128, 416), 1.0), ((2, 8, 19, 37), 1.0),
              ((1, 13, 16, 24), 1.0), ((1, 136, 24, 40), 1.0), ((1, 170, 9, 20), 1.0), ((1, 8, 16, 24), 300.0),
              ((1, 64, 128, 416), 10.0)]


@pytest.mark.parametrize("shape,scale", BAND_CASES)
def test_band_kernel(dev, shape, scale):
    b, d, h, w = shape
    cost = torch.from_numpy(_peaky_cost(b, d, h, w) * np.float32(scale)).to(dev)
    n = soft_argmin_cuda.launches
    got = soft_argmin_cuda(cost, 3 * d)
    torch.cuda.synchronize()
    assert soft_argmin_cuda.launches == n + 1
    ref = soft_argmin(cost.double(), 3 * d)
    assert (got.double() - ref).abs().max().item() < TOL_PX


def _head_case(dev, shape, dtype, kern_dtype=torch.float32):
    b, d, h, w, c = shape
    rng = np.random.RandomState(0)
    vol = torch.from_numpy((rng.randn(b, c, d, h, w) * 0.5).astype(np.float32)).to(dev, dtype)
    kern = torch.from_numpy((rng.randn(1, c, 3, 3, 3) * 0.2).astype(np.float32)).to(dev, kern_dtype)
    return vol, kern


# (b, d, h, w, c). The first three run with fp32 and bf16 volumes; the rest
# are bf16 shapes the sm90 gate admits, ragged against its 8 x 16 tile
# (h, w not multiples of it), C in {16, 32}, D in {8, 16, 64}, then the
# volumes of a fine-tune's val frame (288x576) and of a KITTI frame.
HEAD_SHAPES = [(1, 8, 16, 24, 32), (2, 16, 20, 40, 16), (1, 64, 32, 64, 32)]
SM90_SHAPES = [(1, 8, 5, 8, 16), (1, 16, 13, 56, 16), (2, 8, 19, 72, 32), (1, 64, 37, 104, 32), (1, 64, 96, 192, 32),
               (1, 64, 128, 416, 32)]


@pytest.mark.parametrize(
    "shape,dtype",
    [(s, torch.float32) for s in HEAD_SHAPES] + [(s, torch.bfloat16) for s in HEAD_SHAPES + SM90_SHAPES],
)
def test_fused_head(dev, shape, dtype):
    """The routing wrapper: bf16 volumes the sm90 gate admits launch the sm90
    kernel, fp32 volumes the first design; exactly one counter moves."""
    b, d, h, w, c = shape
    vol, kern = _head_case(dev, shape, dtype)
    route = fused_head_route(c, d, w, 3 * d, dtype)
    assert route == ("sm90" if dtype == torch.bfloat16 else "simt")
    n = conv_soft_argmin_simt.launches, conv_soft_argmin_sm90.launches
    got = conv_soft_argmin_cuda(vol, kern, 3 * d)
    torch.cuda.synchronize()
    moved = (conv_soft_argmin_simt.launches - n[0], conv_soft_argmin_sm90.launches - n[1])
    assert moved == ((0, 1) if route == "sm90" else (1, 0))
    # bf16 volumes: the plain version sees the same bf16 values, upcast.
    ref = conv_soft_argmin_reference(vol.double(), kern.double(), 3 * d)
    assert (got.double() - ref).abs().max().item() < TOL_PX


@pytest.mark.parametrize("shape", [(1, 8, 16, 20, 32), (1, 8, 16, 24, 24)])
def test_fused_head_refused_by_sm90_runs_first_design(dev, shape):
    """bf16 with w % 8 != 0 or C % 16 != 0: the first design's kernel."""
    b, d, h, w, c = shape
    vol, kern = _head_case(dev, shape, torch.bfloat16)
    assert fused_head_route(c, d, w, 3 * d, torch.bfloat16) == "simt"
    n = conv_soft_argmin_simt.launches, conv_soft_argmin_sm90.launches
    got = conv_soft_argmin_cuda(vol, kern, 3 * d)
    torch.cuda.synchronize()
    assert (conv_soft_argmin_simt.launches, conv_soft_argmin_sm90.launches) == (n[0] + 1, n[1])
    ref = conv_soft_argmin_reference(vol.double(), kern.double(), 3 * d)
    assert (got.double() - ref).abs().max().item() < TOL_PX


@pytest.mark.parametrize("kern_dtype", [torch.float32, torch.bfloat16])
def test_fused_head_both_kernels_agree(dev, kern_dtype):
    """On one bf16 volume, the sm90 kernel and the first design; bf16
    weights take the sm90 kernel's one-part contraction."""
    shape = (1, 16, 24, 48, 32)
    vol, kern = _head_case(dev, shape, torch.bfloat16, kern_dtype)
    ref = conv_soft_argmin_reference(vol.double(), kern.double(), 3 * shape[1])
    for fn in (conv_soft_argmin_sm90, conv_soft_argmin_simt):
        n = fn.launches
        got = fn(vol, kern, 3 * shape[1])
        torch.cuda.synchronize()
        assert fn.launches == n + 1
        assert (got.double() - ref).abs().max().item() < TOL_PX


def test_wrappers_raise_instead_of_falling_back(dev):
    with pytest.raises(ValueError):
        soft_argmin_cuda(torch.zeros(1, 8, 16, 16, dtype=torch.float64, device=dev), 24)
    with pytest.raises(ValueError, match="shared memory"):
        soft_argmin_fused(torch.zeros(1, 570, 4, 4, device=dev), 1710)
    with pytest.raises(ValueError):
        conv_soft_argmin_cuda(
            torch.zeros(1, 4, 8, 16, 16, dtype=torch.float16, device=dev),
            torch.zeros(1, 4, 3, 3, 3, device=dev),
            24,
        )


def _kitti_tree(root, names, h=96, w=192):
    """A KITTI-2015-layout tree (``image_2``, ``image_3``, sparse uint16
    ``disp_occ_0``) and a list set ``syn`` naming its frames."""
    from PIL import Image

    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "disp_occ_0"):
        (root / "data" / sub).mkdir(parents=True)
    for name in names:
        for sub in ("image_2", "image_3"):
            Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(root / "data" / sub / name)
        disp = (rng.rand(h, w) * 40 * 256).astype(np.uint16)
        disp[rng.rand(h, w) < 0.7] = 0
        Image.fromarray(disp).save(root / "data" / "disp_occ_0" / name)
    lists = root / "lists" / "syn"
    lists.mkdir(parents=True)
    for split in ("train", "val", "test"):
        (lists / f"{split}.list").write_text("".join(f"image_2/{n}\n" for n in names))


@pytest.mark.parametrize("dtype,kernel", [("bfloat16", conv_soft_argmin_sm90), ("float32", conv_soft_argmin_simt)])
def test_predict_driver_launches_its_head(dev, tmp_path, dtype, kernel):
    """``cli.predict`` on the card: one launch of the dtype's fused head per
    frame and none of the other heads."""
    from leastereo_tpu_torch.cli import predict

    names = ["000000_10.png", "000001_10.png"]
    _kitti_tree(tmp_path, names)
    counters = (conv_soft_argmin_sm90, conv_soft_argmin_simt, soft_argmin_cuda)
    n = [f.launches for f in counters]
    argv = ["--dataset", "kitti15_part", "--data_root", str(tmp_path / "data"), "--listset", "syn",
            "--lists_dir", str(tmp_path / "lists"), "--crop_height", "96", "--crop_width", "192",
            "--maxdisp", "48", "--dtype", dtype, "--output_dir", str(tmp_path / "out")]
    assert predict.main(argv) == 0
    assert [f.launches - k for f, k in zip(counters, n)] == [len(names) if f is kernel else 0 for f in counters]
    for name in names:
        disp = np.load(tmp_path / "out" / f"image_2_{name}.npy")
        assert disp.shape == (96, 192) and np.isfinite(disp).all() and 0 <= disp.min() <= disp.max() <= 48


def test_train_driver_launches_band_kernel_per_step(dev, tmp_path):
    """``cli.train`` on the card, bf16: two epochs of one step each on a
    synthetic 96x192 tree; the band kernel launches once per train step, the
    sm90 head once per val frame, the first fused design never."""
    import json

    from leastereo_tpu_torch.cli import train

    names = ["000000_10.png", "000001_10.png"]
    _kitti_tree(tmp_path, names)
    counters = (soft_argmin_cuda, conv_soft_argmin_sm90, conv_soft_argmin_simt)
    n = [f.launches for f in counters]
    argv = ["--dataset", "kitti15_part", "--data_root", str(tmp_path / "data"), "--listset", "syn",
            "--lists_dir", str(tmp_path / "lists"), "--crop_height", "96", "--crop_width", "192",
            "--maxdisp", "48", "--batch_size", "2", "--epochs", "2", "--workers", "0",
            "--run_root", str(tmp_path / "run"), "--experiment", "card"]
    assert train.main(argv) == 0
    steps, val_frames = 2, 2 * len(names)
    assert [f.launches - k for f, k in zip(counters, n)] == [steps, val_frames, 0]
    exp = tmp_path / "run" / "kitti15_part-train" / "card"
    lines = [json.loads(line) for line in (exp / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite([line["loss"] for line in lines if "loss" in line]).all()
    assert (exp / "checkpoints" / "final" / "2.pth").is_file()


def test_model_raises_on_refused_cost(dev):
    """maxdisp 50 gives D = 16 != 50 / 3: the fused head falls to the band
    kernel, which refuses the CUDA cost; the model raises, launching nothing."""
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=50, compute_dtype="float32"), device=dev)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 48, 96, 3).astype(np.float32)).to(dev)
    counters = (soft_argmin_cuda, conv_soft_argmin_simt, conv_soft_argmin_sm90)
    n = [f.launches for f in counters]
    with torch.no_grad(), pytest.raises(ValueError, match="band kernel refuses"):
        model(x, x)
    assert [f.launches for f in counters] == n
