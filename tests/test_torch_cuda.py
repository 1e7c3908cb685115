"""The port's CUDA kernels against their plain versions, on the card.

Each kernel (``leastereo_tpu_torch/csrc/*.cu``) is built from source on
first use and held against its plain PyTorch version evaluated in float64 on
the same inputs, at small ragged shapes and at the KITTI head shape (the
fp32 sm90 head also on peaky, wide and diffuse inputs, C in {16, 32, 64},
both of its ring layouts; every route at padded and grouped channel counts,
widths TMA cannot read in place and a base 4 bytes past a 16-byte boundary);
``cli.predict`` launches its dtype's head
(bf16: the sm90 head; fp32: the fp32 sm90 head) once per frame, the train driver
the band kernel once per step; both heads pass ``torch.library.opcheck`` as
custom ops on the card, a loaded KITTI ``.pt2`` launches the sm90 head
once per frame, a search weight step and an arch step launch the band
kernel once each, and remat gives the search step's loss, gradients and
running statistics without it; the disparity-sharded resize reproduces
``F.interpolate`` bit for bit, and the sharded forward on a one-shard
partition equals the unsharded plain-head forward (volumes NCDHW) bit for
bit; the NDHWC kernels equal their PyTorch versions (the resize
``F.interpolate``, the stem assembly its ops, the concat ``torch.cat``), the
fused cuDNN epilogue and the sm90 3x3x3 convolution (at every class's
Middlebury and KITTI shapes) stay within bf16 rounding, and a KITTI frame's
matching net runs NDHWC throughout, its 3x3x3 convolutions on the sm90
kernel, and hands the head an NCDHW volume.
Every test skips without a CUDA card. This file imports neither JAX nor the
JAX package, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.ops import _build
from leastereo_tpu_torch.ops.fused_head import (
    conv_soft_argmin_cuda,
    ROUTE_WRAPPERS,
    conv_soft_argmin_reference,
    conv_soft_argmin_sm90,
    conv_soft_argmin_sm90_repitch,
    conv_soft_argmin_sm90_f32,
    conv_soft_argmin_sm90_f32_repitch,
    fused_head_route,
)
from leastereo_tpu_torch.utils.kernel_parity import offset_copy
from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_cuda, soft_argmin_fused
from leastereo_tpu_torch.ops.softargmin import soft_argmin

pytestmark = pytest.mark.cuda

# fp32 kernels against float64: the summation order and __expf differ, 2e-3 px.
TOL_PX = 2e-3

# A bf16 KITTI or Middlebury frame's 3-D eval convolutions by route: the
# 3x3x3 ones of the sm90 kernel's classes, the other ConvBRs with a bias and
# a ReLU (the 1x1x1 ones) fused in cuDNN, the 7 conv-then-resize projections.
FRAME_ROUTES = {"ndhwc_sm90": 73, "ndhwc_fused": 20, "ndhwc": 7, "ncdhw": 0}


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


# (b, d, h, w, c). The first three run with fp32 and bf16 volumes (the fp32
# and the bf16 sm90 kernel); the rest are bf16 shapes the sm90 gate admits,
# ragged against its 8 x 16 tile
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
    kernel, fp32 volumes the fp32 sm90 kernel; exactly one counter moves."""
    b, d, h, w, c = shape
    vol, kern = _head_case(dev, shape, dtype)
    route = fused_head_route(c, d, w, 3 * d, dtype)
    assert route == ("sm90" if dtype == torch.bfloat16 else "sm90_f32")
    n = {r: f.launches for r, f in ROUTE_WRAPPERS.items()}
    got = conv_soft_argmin_cuda(vol, kern, 3 * d)
    torch.cuda.synchronize()
    assert {r: f.launches - n[r] for r, f in ROUTE_WRAPPERS.items()} == {r: int(r == route) for r in ROUTE_WRAPPERS}
    # bf16 volumes: the plain version sees the same bf16 values, upcast.
    ref = conv_soft_argmin_reference(vol.double(), kern.double(), 3 * d)
    assert (got.double() - ref).abs().max().item() < TOL_PX


def _head_kind(dev, shape, kind, seed=0):
    """fp32 volume and kernel as ``chip_smoke.py``'s ``head_inputs`` makes
    them: "peaky" (channel 0 a trained-like cost the kernel's centre tap
    passes), "wide" (its kernel 10x) or "diffuse"."""
    b, d, h, w, c = shape
    rng = np.random.RandomState(seed)
    vol = (0.5 * rng.randn(b, c, d, h, w)).astype(np.float32)
    if kind == "diffuse":
        kern = 0.2 * rng.randn(1, c, 3, 3, 3)
    else:
        vol[:, 0] = _peaky_cost(b, d, h, w, seed + 1)
        kern = 0.02 * rng.randn(1, c, 3, 3, 3)
        kern[0, 0, 1, 1, 1] += 1.0
        kern *= 10.0 if kind == "wide" else 1.0
    return torch.from_numpy(vol).to(dev), torch.from_numpy(kern.astype(np.float32)).to(dev)


# (b, d, h, w, c) of the fp32 sm90 kernel: C in {16, 32, 64}, B = 2, D = 16
# and 64, ragged h and w = 4 (mod 8) (a bf16 volume's w must be a multiple of
# 8); one stage in half an SM (C = 32, D = 64: two blocks an SM), two stages
# (C = 16, D = 16), two in a whole SM (C = 64, D = 64; C = 32, D = 136), one
# in a whole SM (C = 64, D = 136); the volumes of a fine-tune's val frame and
# of a KITTI frame.
F32_SHAPES = [(2, 16, 13, 44, 16), (2, 64, 19, 36, 32), (2, 16, 11, 28, 64), (1, 64, 37, 100, 64),
              (1, 136, 9, 20, 32), (1, 136, 9, 20, 64), (1, 64, 96, 192, 32), (1, 64, 128, 416, 32)]


@pytest.mark.parametrize("kind", ["peaky", "wide", "diffuse"])
@pytest.mark.parametrize("shape", F32_SHAPES)
def test_fused_head_sm90_f32(dev, shape, kind):
    """The fp32 sm90 kernel (3xTF32 contraction) against float64, with the
    TF32 flags of cuDNN and cuBLAS on: they must not change its arithmetic."""
    b, d, h, w, c = shape
    vol, kern = _head_kind(dev, shape, kind)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    assert fused_head_route(c, d, w, 3 * d, torch.float32) == "sm90_f32"
    counters = (conv_soft_argmin_sm90_f32, conv_soft_argmin_sm90, conv_soft_argmin_sm90_repitch,
                conv_soft_argmin_sm90_f32_repitch)
    n = [f.launches for f in counters]
    got = conv_soft_argmin_cuda(vol, kern, 3 * d)
    torch.cuda.synchronize()
    assert [f.launches - k for f, k in zip(counters, n)] == [1, 0, 0, 0]
    ref = conv_soft_argmin_reference(vol.double(), kern.double(), 3 * d)
    assert (got.double() - ref).abs().max().item() < TOL_PX


# Shapes no sm90 route took before channel padding, channel groups and the
# repitch routes: C = 8 (fp32: a second box wholly past C), 12 and 24
# (padded to 16 and 32), 40 (to 48), 80 (three 32-channel groups, the last
# one's upper fp32 box wholly past C); w = 416 (in place), 412 (bf16:
# repitched, w % 8 = 4; fp32: in place), 413 and 414 (repitched both); a
# small h and D.
ROUTE_CHANNELS = (8, 12, 24, 40, 80)
ROUTE_WIDTHS = (416, 412, 413, 414)


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("w", ROUTE_WIDTHS)
@pytest.mark.parametrize("c", ROUTE_CHANNELS)
def test_fused_head_routes(dev, c, w, b, dtype, offset):
    """Every route at padded and grouped C, widths TMA cannot read in place,
    and a base ``offset`` bytes past a 16-byte boundary: peaky, wide and diffuse
    inputs within 2e-3 px of float64, one launch of the route's counter and
    none of the others each."""
    d, h = 16, 9
    route = fused_head_route(c, d, w, 3 * d, dtype, aligned=offset == 0)
    in_place = w * dtype.itemsize % 16 == 0 and offset == 0
    assert route == ("sm90" if dtype == torch.bfloat16 else "sm90_f32") + ("" if in_place else "_repitch")
    for seed, kind in enumerate(("peaky", "wide", "diffuse")):
        vol, kern = _head_kind(dev, (b, d, h, w, c), kind, seed=seed)
        vol = offset_copy(vol.to(dtype), offset)
        assert vol.data_ptr() % 16 == offset
        n = {r: f.launches for r, f in ROUTE_WRAPPERS.items()}
        got = conv_soft_argmin_cuda(vol, kern, 3 * d)
        torch.cuda.synchronize()
        assert {r: f.launches - n[r] for r, f in ROUTE_WRAPPERS.items()} == {r: int(r == route) for r in ROUTE_WRAPPERS}
        ref = conv_soft_argmin_reference(vol.double(), kern.double(), 3 * d)
        assert (got.double() - ref).abs().max().item() < TOL_PX, kind


@pytest.mark.parametrize("kern_dtype", [torch.float32, torch.bfloat16])
def test_fused_head_fp32_kernels_agree(dev, kern_dtype):
    """On one fp32 volume, the fp32 in-place and repitch routes; bf16 weights
    (tf32 values) take the fp32 contraction's two-product form."""
    shape = (1, 16, 24, 48, 32)
    vol, kern = _head_case(dev, shape, torch.float32, kern_dtype)
    ref = conv_soft_argmin_reference(vol.double(), kern.double(), 3 * shape[1])
    for fn in (conv_soft_argmin_sm90_f32, conv_soft_argmin_sm90_f32_repitch):
        n = fn.launches
        got = fn(vol, kern, 3 * shape[1])
        torch.cuda.synchronize()
        assert fn.launches == n + 1
        assert (got.double() - ref).abs().max().item() < TOL_PX


@pytest.mark.parametrize("kern_dtype", [torch.float32, torch.bfloat16])
def test_fused_head_both_kernels_agree(dev, kern_dtype):
    """On one bf16 volume, the bf16 in-place and repitch routes; bf16 weights
    take the one-part contraction."""
    shape = (1, 16, 24, 48, 32)
    vol, kern = _head_case(dev, shape, torch.bfloat16, kern_dtype)
    ref = conv_soft_argmin_reference(vol.double(), kern.double(), 3 * shape[1])
    for fn in (conv_soft_argmin_sm90, conv_soft_argmin_sm90_repitch):
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
    # Each sm90 wrapper takes its own volume type only.
    vol, kern = torch.zeros(1, 16, 8, 16, 16, device=dev), torch.zeros(1, 16, 3, 3, 3, device=dev)
    with pytest.raises(ValueError, match="bfloat16 volume"):
        conv_soft_argmin_sm90(vol, kern, 24)
    with pytest.raises(ValueError, match="float32 volume"):
        conv_soft_argmin_sm90_f32(vol.bfloat16(), kern, 24)
    # An in-place route takes neither rows of partial 16-byte lines nor an unaligned base.
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv_soft_argmin_sm90(torch.zeros(1, 16, 8, 16, 20, dtype=torch.bfloat16, device=dev), kern, 24)
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv_soft_argmin_sm90_f32(offset_copy(vol, 4), kern, 24)


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


@pytest.mark.parametrize("dtype,kernel", [("bfloat16", conv_soft_argmin_sm90), ("float32", conv_soft_argmin_sm90_f32)])
def test_predict_driver_launches_its_head(dev, tmp_path, dtype, kernel):
    """``cli.predict`` on the card: one launch of the dtype's fused head per
    frame and none of the other heads."""
    from leastereo_tpu_torch.cli import predict

    names = ["000000_10.png", "000001_10.png"]
    _kitti_tree(tmp_path, names)
    counters = (conv_soft_argmin_sm90, conv_soft_argmin_sm90_f32, conv_soft_argmin_sm90_repitch,
                conv_soft_argmin_sm90_f32_repitch, soft_argmin_cuda)
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
    sm90 head once per val frame, the other head routes never."""
    import json

    from leastereo_tpu_torch.cli import train

    names = ["000000_10.png", "000001_10.png"]
    _kitti_tree(tmp_path, names)
    counters = (soft_argmin_cuda, conv_soft_argmin_sm90, conv_soft_argmin_sm90_repitch,
                conv_soft_argmin_sm90_f32, conv_soft_argmin_sm90_f32_repitch)
    n = [f.launches for f in counters]
    argv = ["--dataset", "kitti15_part", "--data_root", str(tmp_path / "data"), "--listset", "syn",
            "--lists_dir", str(tmp_path / "lists"), "--crop_height", "96", "--crop_width", "192",
            "--maxdisp", "48", "--batch_size", "2", "--epochs", "2", "--workers", "0",
            "--run_root", str(tmp_path / "run"), "--experiment", "card"]
    assert train.main(argv) == 0
    steps, val_frames = 2, 2 * len(names)
    assert [f.launches - k for f, k in zip(counters, n)] == [steps, val_frames, 0, 0, 0]
    exp = tmp_path / "run" / "kitti15_part-train" / "card"
    lines = [json.loads(line) for line in (exp / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite([line["loss"] for line in lines if "loss" in line]).all()
    assert (exp / "checkpoints" / "final" / "2.pth").is_file()


def test_model_raises_on_refused_cost(dev):
    """maxdisp 50 gives D = 16 != 50 / 3: the fused head falls to the band
    kernel, which refuses the CUDA cost; the model raises, launching nothing."""
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=50, compute_dtype="float32"), device=dev)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 48, 96, 3).astype(np.float32)).to(dev)
    counters = (soft_argmin_cuda, conv_soft_argmin_sm90_repitch, conv_soft_argmin_sm90,
                conv_soft_argmin_sm90_f32, conv_soft_argmin_sm90_f32_repitch)
    n = [f.launches for f in counters]
    with torch.no_grad(), pytest.raises(ValueError, match="band kernel refuses"):
        model(x, x)
    assert [f.launches for f in counters] == n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ops_pass_opcheck_on_card(dev, dtype):
    """Both heads as custom ops on CUDA tensors: schema, autograd
    registration, fake tensors and AOT dispatch (the bf16 volume routes to
    the sm90 kernel, fp32 to the fp32 sm90 kernel; the band kernel takes a
    bf16 cost as its fp32 copy)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    vol = torch.randn(1, 16, 8, 8, 16, generator=gen, device=dev).to(dtype).requires_grad_(True)
    kern = (0.2 * torch.randn(1, 16, 3, 3, 3, generator=gen, device=dev)).requires_grad_(True)
    torch.library.opcheck(torch.ops.leastereo.conv_soft_argmin.default, (vol, kern, 24))
    cost = torch.from_numpy(_peaky_cost(2, 8, 5, 40)).to(dev).to(dtype).requires_grad_(True)
    torch.library.opcheck(torch.ops.leastereo.band_soft_argmin.default, (cost, 24))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ndhwc_ops_pass_opcheck_on_card(dev, dtype):
    """The custom ops a traced eval matching net holds, on NDHWC CUDA
    volumes: the resize (either output layout) and the fused convolution."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cl = torch.channels_last_3d
    x = torch.randn(1, 16, 4, 6, 8, generator=gen, device=dev).to(dtype).contiguous(memory_format=cl)
    for ncdhw in (False, True):
        torch.library.opcheck(torch.ops.leastereo.resize3d_ndhwc.default, (x, [7, 11, 15], ncdhw))
    w = (0.2 * torch.randn(8, 16, 3, 3, 3, generator=gen, device=dev)).to(dtype, memory_format=cl)
    b = torch.randn(8, generator=gen, device=dev).to(dtype)
    torch.library.opcheck(torch.ops.leastereo.conv_bias_relu.default, (x, w, b, [1, 1, 1], [1, 1, 1]))
    if dtype == torch.bfloat16:
        w16 = (0.2 * torch.randn(16, 16, 3, 3, 3, generator=gen, device=dev)).to(dtype, memory_format=cl)
        b16 = torch.randn(16, generator=gen, device=dev).to(dtype)
        torch.library.opcheck(torch.ops.leastereo.conv3d_bias_relu_sm90.default, (x, w16, b16))


def test_band_op_raises_on_refused_cost(dev):
    """The op's CUDA implementation keeps the wrapper's gate: no plain fallback."""
    n = soft_argmin_cuda.launches
    with pytest.raises(ValueError, match="band kernel refuses"):
        torch.ops.leastereo.band_soft_argmin(torch.zeros(1, 8, 4, 4, device=dev), 25)
    with pytest.raises(ValueError, match="shared memory"):
        torch.ops.leastereo.band_soft_argmin(torch.zeros(1, 570, 4, 4, device=dev), 1710)
    assert soft_argmin_cuda.launches == n


def test_loaded_kitti_program_launches_sm90_per_frame(dev, tmp_path):
    """``cli.export``'s program at the KITTI shape, saved and loaded: the sm90
    head once per frame and no other head, the sm90 3x3x3 convolution at each
    of its calls, equal to the eager model."""
    from leastereo_tpu_torch.cli.export import export_pt2
    from leastereo_tpu_torch.ops.conv3d import conv3d_bias_relu_sm90

    model = best_sceneflow_model(LEAStereoConfig(maxdisp=192, compute_dtype="bfloat16"), device=dev)
    path = tmp_path / "kitti.pt2"
    torch.export.save(export_pt2(model, 384, 1248, dev), path)
    prog = torch.export.load(path).module()
    rng = np.random.RandomState(0)
    frames = [tuple(torch.from_numpy(rng.randn(1, 384, 1248, 3).astype(np.float32)).to(dev) for _ in range(2))
              for _ in range(2)]
    counters = (conv_soft_argmin_sm90, conv_soft_argmin_sm90_repitch, conv_soft_argmin_sm90_f32,
                conv_soft_argmin_sm90_f32_repitch, soft_argmin_cuda, conv3d_bias_relu_sm90)
    n = [f.launches for f in counters]
    with torch.inference_mode():
        got = [prog(left, right) for left, right in frames]
    assert [f.launches - k for f, k in zip(counters, n)] == [len(frames), 0, 0, 0, 0,
                                                            FRAME_ROUTES["ndhwc_sm90"] * len(frames)]
    with torch.inference_mode():
        for g, (left, right) in zip(got, frames):
            assert g.shape == (1, 384, 1248)
            assert torch.equal(g, model(left, right))


def _search_setup(dev, remat, seed=3):
    """A small fp32 supernet (3-layer filter-2 block-2 step-2 nets, maxdisp
    48) on the card, its two optimizers and a 96x192 batch of 2."""
    from leastereo_tpu_torch.search import AutoStereoSupernet, SupernetConfig, make_arch_optimizer, make_weight_optimizer

    cfg = SupernetConfig(3, 2, 2, 2, remat=remat)
    model = AutoStereoSupernet(48, cfg, cfg, dtype=torch.float32, generator=torch.Generator().manual_seed(seed)).to(dev)
    rng = np.random.RandomState(seed)
    batch = {"left": rng.randn(2, 96, 192, 3).astype(np.float32), "right": rng.randn(2, 96, 192, 3).astype(np.float32),
             "disparity": rng.uniform(0, 47, (2, 96, 192)).astype(np.float32)}
    return model, make_weight_optimizer(model.weight_parameters(), 0.025), make_arch_optimizer(model.arch_parameters()), batch


def test_search_steps_launch_band_kernel_once(dev):
    """A search weight step and an arch step each launch the band kernel
    once (the supernet's head), and no fused head."""
    from leastereo_tpu_torch.search import arch_step, weight_step

    model, opt_w, opt_a, batch = _search_setup(dev, remat=True)
    counters = (soft_argmin_cuda, conv_soft_argmin_sm90, conv_soft_argmin_sm90_repitch,
                conv_soft_argmin_sm90_f32, conv_soft_argmin_sm90_f32_repitch)
    n = [f.launches for f in counters]
    m = weight_step(model, opt_w, batch, 48, 0.025)
    assert [f.launches - k for f, k in zip(counters, n)] == [1, 0, 0, 0, 0]
    arch_step(model, opt_a, batch, 48)
    assert [f.launches - k for f, k in zip(counters, n)] == [2, 0, 0, 0, 0]
    assert np.isfinite(m["loss"])


def test_search_remat_matches_no_remat_on_card(dev):
    """One weight step with remat on and off: equal loss, gradients within
    1e-4 relative, and equal running statistics (the recomputation in the
    backward pass does not move them again)."""
    from leastereo_tpu_torch.search import weight_step

    runs = {}
    for remat in (True, False):
        model, opt_w, _, batch = _search_setup(dev, remat)
        m = weight_step(model, opt_w, batch, 48, 0.025)
        runs[remat] = (m["loss"], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
                       model.state_dict())
    (loss_on, g_on, sd_on), (loss_off, g_off, sd_off) = runs[True], runs[False]
    assert loss_on == pytest.approx(loss_off, rel=1e-6)
    assert g_on.keys() == g_off.keys()
    for k, g in g_off.items():
        rel = ((g_on[k] - g).norm() / (g.norm() + 1e-30)).item()
        assert rel < 1e-4, (k, rel)
    for k, v in sd_off.items():
        if "running" in k or "num_batches" in k:
            torch.testing.assert_close(sd_on[k], v, rtol=1e-6, atol=1e-7, msg=k)


@pytest.mark.parametrize("src,dst", [((17, 16, 52), (34, 32, 104)), ((64, 128, 416), (32, 64, 208)),
                                     ((68, 32, 104), (136, 128, 416)), ((9, 8, 10), (5, 4, 5))])
def test_sharded_resize_is_interpolate_bit_for_bit(dev, src, dst):
    """The slab resize's arithmetic is PyTorch's trilinear kernel's, so a
    sharded volume's planes are the unsharded ones exactly (on one shard
    here; each output plane's arithmetic does not depend on the slab)."""
    from leastereo_tpu_torch.ops.resize import resize3d
    from leastereo_tpu_torch.parallel import DispPartition

    x = torch.randn(1, 8, *src, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    want = torch.nn.functional.interpolate(x, size=dst, mode="trilinear", align_corners=True)
    assert torch.equal(resize3d(x, dst, part=DispPartition(src[0])), want)


@pytest.mark.parametrize("maxdisp", [48, 408])
def test_sharded_forward_on_one_shard_is_unsharded(dev, maxdisp, monkeypatch):
    """``cost_volume_pspec`` without a mesh runs the slab path on one shard:
    halo-padded convolutions, the sharded resize and head, no head kernel.
    In fp32 it equals bit for bit the plain-head forward whose volumes stay
    NCDHW, as the slab's do, and the NDHWC one within the fp32 tolerance
    (cuDNN's NDHWC convolutions sum in another order)."""
    from leastereo_tpu_torch.models.matching_net import MatchingNet

    rng = np.random.RandomState(0)
    left, right = (torch.from_numpy(rng.randn(1, 96, 192, 3).astype(np.float32)).to(dev) for _ in range(2))
    plain = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="float32", pallas_head=False))
    sharded = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="float32",
                                                   cost_volume_pspec=("data", "disp")))
    sharded.load_state_dict(plain.state_dict())
    counts = (conv_soft_argmin_sm90.launches, conv_soft_argmin_sm90_f32.launches, soft_argmin_cuda.launches)
    with torch.inference_mode():
        ndhwc, got = plain(left, right), sharded(left, right)
        monkeypatch.setattr(MatchingNet, "layout", lambda self, part: torch.contiguous_format)
        want = plain(left, right)
    assert (conv_soft_argmin_sm90.launches, conv_soft_argmin_sm90_f32.launches, soft_argmin_cuda.launches) == counts
    assert torch.isfinite(got).all() and torch.equal(got, want)
    assert (ndhwc - want).abs().max().item() < TOL_PX


# (C, source DHW, output DHW) of the NDHWC resize kernel: the matching net's
# resizes at a KITTI frame (downsampling by 2 and upsampling to 1/3
# resolution, C in {8, 16, 32, 64}), odd and ragged sizes, and C = 3 (no
# 16-byte words: one element a thread).
NDHWC_RESIZES = [(32, (64, 128, 416), (32, 64, 208)), (64, (32, 64, 208), (16, 32, 104)),
                 (16, (16, 32, 104), (32, 64, 208)), (8, (32, 64, 208), (64, 128, 416)),
                 (32, (17, 16, 52), (34, 32, 104)), (32, (9, 8, 10), (5, 4, 5)), (3, (5, 6, 7), (9, 11, 13))]
# The kernel's arithmetic is PyTorch's trilinear kernel's: bf16 and fp32
# agree bit for bit. fp16 and fp64 are held to a last-bit tolerance (the
# two compilations may contract other products into FMAs).
RESIZE_TOL = {torch.float16: dict(rtol=2 ** -10, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.mark.parametrize("ncdhw_out", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,src,dst", NDHWC_RESIZES)
def test_ndhwc_resize_kernel(dev, c, src, dst, dtype, ncdhw_out):
    """``lst_resize_ndhwc`` equals ``F.interpolate`` on the NCDHW volume bit
    for bit, in either output layout; one launch a call."""
    from leastereo_tpu_torch.ops.layout import is_ndhwc
    from leastereo_tpu_torch.ops.resize import resize3d, resize3d_ndhwc_cuda

    x = torch.randn(1, c, *src, generator=torch.Generator(device=dev).manual_seed(1), device=dev).to(dtype)
    want = torch.nn.functional.interpolate(x, size=dst, mode="trilinear", align_corners=True)
    fmt = torch.contiguous_format if ncdhw_out else torch.channels_last_3d
    n = resize3d_ndhwc_cuda.launches
    got = resize3d(x.contiguous(memory_format=torch.channels_last_3d), dst, memory_format=fmt)
    torch.cuda.synchronize()
    assert resize3d_ndhwc_cuda.launches == n + 1
    assert got.is_contiguous() if ncdhw_out else is_ndhwc(got)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_ndhwc_resize_kernel_types_and_unaligned_base(dev, dtype):
    """fp16 and fp64 volumes, and a volume whose base is not 16-byte aligned
    (one element a thread)."""
    from leastereo_tpu_torch.ops.resize import resize3d_ndhwc_cuda

    c, src, dst = 16, (9, 20, 36), (17, 39, 71)
    x = torch.randn(1, c, *src, generator=torch.Generator(device=dev).manual_seed(2), device=dev).to(dtype)
    cl = x.contiguous(memory_format=torch.channels_last_3d)
    flat = torch.empty(cl.numel() + 1, dtype=dtype, device=dev)
    shifted = flat[1:].view(1, *src, c).permute(0, 4, 1, 2, 3)
    shifted.copy_(cl)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous(memory_format=torch.channels_last_3d)
    want = torch.nn.functional.interpolate(x, size=dst, mode="trilinear", align_corners=True)
    for vol in (cl, shifted):
        for fmt in (torch.channels_last_3d, torch.contiguous_format):
            torch.testing.assert_close(resize3d_ndhwc_cuda(vol, dst, fmt), want, **RESIZE_TOL[dtype])


@pytest.mark.parametrize("cin,cout,k,dhw", [(32, 32, 3, (64, 128, 416)), (16, 16, 3, (32, 64, 208)),
                                            (8, 8, 3, (64, 128, 416)), (64, 16, 1, (32, 64, 208))])
def test_convbr_fused_epilogue(dev, cin, cout, k, dhw):
    """A bf16 eval ConvBR at the KITTI frame's shapes: its fused route (the
    sm90 kernel for the 3x3x3 classes, else one cuDNN call, bias and ReLU in
    the epilogue either way; cuDNN's fused call is also run on the 3x3x3
    ones), the unfused NDHWC route and the NCDHW route each within bf16
    rounding of the float64 result on the same bf16 input and kernel: one
    rounding fused, two (the convolution's, then the bias add's) otherwise."""
    from leastereo_tpu_torch.ops.convbr import ConvBR, conv_bias_relu_cudnn
    from leastereo_tpu_torch.ops.layout import is_ndhwc

    gen = torch.Generator().manual_seed(3)
    conv = ConvBR(cin, cout, k, 1, k // 2, ndim=3, generator=gen).to(dev).eval()
    conv.bn.running_mean.normal_(0, 0.3)
    conv.bn.running_var.uniform_(0.5, 2.0)
    conv.bn.bias.data.normal_(0, 0.3)
    x = torch.relu(torch.randn(1, cin, *dhw, device=dev)).to(torch.bfloat16)
    xc = x.contiguous(memory_format=torch.channels_last_3d)
    weight, bias = conv.folded()
    w16, b16 = weight.to(torch.bfloat16), bias.to(torch.bfloat16)
    pre = torch.nn.functional.conv3d(x.double(), w16.double(), padding=k // 2)
    exact = torch.relu(pre + b16.double().view(1, -1, 1, 1, 1))
    before = dict(ConvBR.eval_routes)
    with torch.inference_mode():
        fused = conv(xc)
        unfused = torch.relu(conv.eval_conv(xc, relu=False))
        ncdhw = conv(x)
        cudnn = conv_bias_relu_cudnn(xc, w16.contiguous(memory_format=torch.channels_last_3d), b16, [1] * 3,
                                     [k // 2] * 3)
    route = "ndhwc_sm90" if k == 3 else "ndhwc_fused"
    assert {r: v - before[r] for r, v in ConvBR.eval_routes.items()} == {
        "ndhwc_sm90": 0, "ndhwc_fused": 0, route: 1, "ndhwc": 1, "ncdhw": 1}
    assert is_ndhwc(fused) and is_ndhwc(unfused) and is_ndhwc(cudnn) and ncdhw.is_contiguous()
    scale = exact.abs().max().item()
    for got, rounds_sum in ((fused, False), (cudnn, False), (unfused, True), (ncdhw, True)):
        err = (got.double() - exact).abs()
        # A bf16 rounding moves a value by at most 2^-9 of it (bound: twice
        # that): of the result, and on the unfused routes first of the sum
        # before the bias; the fp32 sums are exact to far less.
        bound = 2 ** -8 * (exact.abs() + pre.abs() * rounds_sum) + 1e-5 * scale
        assert (err <= bound).all(), err.max().item()


# The matching net's 3x3x3 classes, (C_in, C_out, (D, H, W)): at a
# Middlebury frame (maxdisp 408, 1008x1512), then a KITTI one (192, 384x1248).
CONV3D_CLASSES = [(128, 64, (68, 168, 252)), (16, 16, (68, 168, 252)), (32, 32, (136, 336, 504)),
                  (8, 8, (136, 336, 504)), (32, 32, (34, 84, 126)),
                  (128, 64, (32, 64, 208)), (16, 16, (32, 64, 208)), (32, 32, (64, 128, 416)),
                  (8, 8, (64, 128, 416)), (32, 32, (16, 32, 104))]


@pytest.mark.parametrize("cin,cout,dhw", [c for c in CONV3D_CLASSES if c[:2] in _build.CONV3D_SM90_TILES])
def test_conv3d_sm90_kernel(dev, cin, cout, dhw):
    """The sm90 3x3x3 convolution at each class's frame shapes against its
    plain version's fp32 sums (fp32, TF32 off): within one bf16 rounding,
    the bound ``test_convbr_fused_epilogue`` states for a fused route."""
    from leastereo_tpu_torch.ops.conv3d import conv3d_bias_relu_sm90

    gen = torch.Generator(device=dev).manual_seed(cin + dhw[0])
    cl = torch.channels_last_3d
    x = torch.relu(torch.randn(1, cin, *dhw, generator=gen, device=dev)).to(torch.bfloat16).contiguous(memory_format=cl)
    w = (torch.randn(cout, cin, 3, 3, 3, generator=gen, device=dev) / (27 * cin) ** 0.5).to(torch.bfloat16,
                                                                                             memory_format=cl)
    b = (0.3 * torch.randn(cout, generator=gen, device=dev)).to(torch.bfloat16)
    launches = conv3d_bias_relu_sm90.launches
    got = conv3d_bias_relu_sm90(x, w, b)
    assert conv3d_bias_relu_sm90.launches == launches + 1 and got.is_contiguous(memory_format=cl)
    del gen
    exact = torch.relu(torch.nn.functional.conv3d(x.float(), w.float(), b.float(), padding=1))
    scale = exact.abs().max().item()
    err = (got.float() - exact).abs_()
    assert (err <= 2 ** -8 * exact.abs() + 1e-5 * scale).all(), err.max().item()


def test_conv3d_sm90_wrapper_raises(dev):
    """The wrapper takes its classes' NDHWC bf16 volumes at a 16-byte aligned
    base with a channels_last_3d kernel, and raises on anything else."""
    from leastereo_tpu_torch.ops.conv3d import conv3d_bias_relu_sm90

    cl = torch.channels_last_3d
    x = torch.zeros(1, 16, 4, 6, 8, dtype=torch.bfloat16, device=dev).contiguous(memory_format=cl)
    w = torch.zeros(16, 16, 3, 3, 3, dtype=torch.bfloat16, device=dev).contiguous(memory_format=cl)
    b = torch.zeros(16, dtype=torch.bfloat16, device=dev)
    conv3d_bias_relu_sm90(x, w, b)
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = flat[1:].view(1, 4, 6, 8, 16).permute(0, 4, 1, 2, 3)
    bad = [(x.float(), w.float(), b.float()), (x.contiguous(), w, b), (x, w.contiguous(), b), (shifted, w, b),
           (x[:, :8], w[:8, :8].contiguous(memory_format=cl), b[:8].clone()),
           (torch.zeros(1, 24, 4, 6, 8, dtype=x.dtype, device=dev).contiguous(memory_format=cl),
            torch.zeros(24, 24, 3, 3, 3, dtype=x.dtype, device=dev).contiguous(memory_format=cl),
            torch.zeros(24, dtype=x.dtype, device=dev))]
    for args in bad:
        with pytest.raises(ValueError, match="sm90 3x3x3"):
            conv3d_bias_relu_sm90(*args)


def _informative_state(dev, seed):
    """BEST_SCENEFLOW's weights at maxdisp 192 from ``seed``, its BN
    statistics those of one seeded frame (a float32 train-mode pass with
    momentum 1) and ``last_3`` scaled so the cost spans a few units: a net
    whose disparity follows its volume, where a fresh init's costs are flat."""
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=192, compute_dtype="float32"), device=dev, seed=seed)
    rng = np.random.RandomState(seed)
    left, right = (torch.from_numpy(rng.randn(1, 192, 624, 3).astype(np.float32)).to(dev) for _ in range(2))
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.momentum = 1.0
    with torch.no_grad():
        model.train()(left, right)
        model.eval()
        feats = model.feature(torch.cat([left, right]).permute(0, 3, 1, 2))
        cost = model.matching.last_3(model.matching(feats[:1], feats[1:], 64))
        model.matching.last_3.conv.weight.mul_(3.0 / cost.std())
    return model.state_dict()


def test_kitti_frame_volumes_are_ndhwc(dev, monkeypatch):
    """A KITTI-shaped bf16 frame: the stem written NDHWC by its kernel, every
    3-D eval ConvBR of the matching net (its 75 3x3x3 and 25 1x1x1
    convolutions) on an NDHWC route, the 3x3x3 ones on the sm90 kernel, its
    17 resizes and 14 concatenations in the NDHWC kernels, the fused head
    launched once on a contiguous NCDHW volume and no other head, a finite
    map within [0, maxdisp]. The float32 frame (TF32 off) whose volumes stay NDHWC is within
    ``TOL_PX`` of the one whose volumes stay NCDHW throughout: only cuDNN's
    summation order differs between them."""
    import leastereo_tpu_torch.models.leastereo as lst
    from leastereo_tpu_torch.models.matching_net import MatchingNet
    from leastereo_tpu_torch.ops.conv3d import conv3d_bias_relu_sm90
    from leastereo_tpu_torch.ops.convbr import ConvBR
    from leastereo_tpu_torch.ops.fused_stem import stem_ndhwc_cuda
    from leastereo_tpu_torch.ops.layout import cat_ndhwc_cuda
    from leastereo_tpu_torch.ops.resize import resize3d_ndhwc_cuda

    state = _informative_state(dev, seed=4)
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=192), device=dev)
    model.load_state_dict(state)
    rng = np.random.RandomState(4)
    left, right = (torch.from_numpy(rng.randn(1, 384, 1248, 3).astype(np.float32)).to(dev) for _ in range(2))
    vols, head = [], lst.conv_soft_argmin_fused
    monkeypatch.setattr(lst, "conv_soft_argmin_fused", lambda vol, k, m: vols.append(vol) or head(vol, k, m))
    kernels = (conv_soft_argmin_sm90, resize3d_ndhwc_cuda, stem_ndhwc_cuda, cat_ndhwc_cuda, conv3d_bias_relu_sm90,
               conv_soft_argmin_sm90_repitch, conv_soft_argmin_sm90_f32, conv_soft_argmin_sm90_f32_repitch,
               soft_argmin_cuda)

    def routes_of(fn):
        before = dict(ConvBR.eval_routes)
        out = fn()
        return out, {r: v - before[r] for r, v in ConvBR.eval_routes.items()}

    launches = [f.launches for f in kernels]
    with torch.inference_mode():
        got, delta = routes_of(lambda: model(left, right))
        torch.cuda.synchronize()
        # The 7 conv-then-resize projections (models/cells.py) apply their ReLU after the resize.
        assert delta == FRAME_ROUTES
        assert [f.launches - n for f, n in zip(kernels, launches)] == [1, 17, 1, 14, FRAME_ROUTES["ndhwc_sm90"],
                                                                       0, 0, 0, 0]
        assert len(vols) == 1 and vols[0].shape == (1, 32, 64, 128, 416) and vols[0].is_contiguous()
        assert got.shape == (1, 384, 1248) and torch.isfinite(got).all()
        assert 0 <= got.min().item() and got.max().item() <= 192
        model32 = best_sceneflow_model(LEAStereoConfig(maxdisp=192, compute_dtype="float32"), device=dev)
        model32.load_state_dict(state)
        got32, delta = routes_of(lambda: model32(left, right))
        assert delta == {"ndhwc_sm90": 0, "ndhwc_fused": 93, "ndhwc": 7, "ncdhw": 0}
        monkeypatch.setattr(MatchingNet, "layout", lambda self, part: torch.contiguous_format)
        want32, delta = routes_of(lambda: model32(left, right))
        assert delta == {"ndhwc_sm90": 0, "ndhwc_fused": 0, "ndhwc": 0, "ncdhw": 100}
    gap = (got32 - want32).abs()
    print(f"float32 NDHWC vs NCDHW frame: mean {gap.mean().item():.3e} px, max {gap.max().item():.3e} px")
    assert gap.max().item() < TOL_PX


# (b, h, w, c, f, num_disp, planes) of the NDHWC stem kernel: the fused stem
# test's cases (D == w, D = 1, D > w), a slab of planes, F = 6 (no 16-byte
# words) and a KITTI frame's stem (1/3 resolution, 32 features).
STEM_CASES = [(1, 8, 12, 4, 8, 5, None), (2, 6, 9, 3, 16, 9, None), (1, 4, 6, 2, 8, 1, None),
              (1, 4, 6, 2, 8, 10, (3, 8)), (1, 5, 7, 3, 6, 4, None), (1, 128, 416, 32, 32, 64, None)]


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,f,num_disp,planes", STEM_CASES)
def test_stem_ndhwc_kernel(dev, b, h, w, c, f, num_disp, planes, dtype, epilogue):
    """``lst_stem_ndhwc`` writes the fused stem's NDHWC output bit for bit as
    the PyTorch ops of its NCDHW output; one launch a call."""
    from leastereo_tpu_torch.ops.layout import is_ndhwc
    from leastereo_tpu_torch.ops.fused_stem import fused_cost_volume_stem, stem_ndhwc_cuda

    gen = torch.Generator(device=dev).manual_seed(5)
    left, right = (torch.randn(b, c, h, w, generator=gen, device=dev).to(dtype) for _ in range(2))
    kernel = 0.2 * torch.randn(f, 2 * c, 3, 3, 3, generator=gen, device=dev)
    bias = torch.randn(f, generator=gen, device=dev) if epilogue else None
    kw = dict(bias=bias, relu=epilogue, planes=planes)
    want = fused_cost_volume_stem(left, right, kernel, num_disp, **kw)
    n = stem_ndhwc_cuda.launches
    got = fused_cost_volume_stem(left, right, kernel, num_disp, memory_format=torch.channels_last_3d, **kw)
    torch.cuda.synchronize()
    assert stem_ndhwc_cuda.launches == n + 1 and is_ndhwc(got)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels", [(8, 8, 8, 8), (16, 16, 16, 16), (32, 32, 32, 32), (32, 64), (3, 5, 8)])
def test_cat_ndhwc_kernel(dev, channels, dtype):
    """``lst_cat_ndhwc`` joins NDHWC volumes as ``torch.cat`` does, bit for
    bit (3 and 5 channels: one element a thread); one launch a call."""
    from leastereo_tpu_torch.ops.layout import cat_channels, cat_ndhwc_cuda, is_ndhwc

    gen = torch.Generator(device=dev).manual_seed(6)
    xs = [torch.randn(2, c, 5, 12, 33, generator=gen, device=dev).to(dtype) for c in channels]
    n = cat_ndhwc_cuda.launches
    got = cat_channels([x.contiguous(memory_format=torch.channels_last_3d) for x in xs])
    torch.cuda.synchronize()
    assert cat_ndhwc_cuda.launches == n + 1 and is_ndhwc(got)
    assert torch.equal(got, torch.cat(xs, dim=1))
