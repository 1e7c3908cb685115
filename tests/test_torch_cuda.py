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
partition equals the unsharded plain-head forward bit for bit. Every test
skips without a CUDA card. This file imports neither JAX
nor the JAX package, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
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
    head once per frame and no other head, equal to the eager model."""
    from leastereo_tpu_torch.cli.export import export_pt2

    model = best_sceneflow_model(LEAStereoConfig(maxdisp=192, compute_dtype="bfloat16"), device=dev)
    path = tmp_path / "kitti.pt2"
    torch.export.save(export_pt2(model, 384, 1248, dev), path)
    prog = torch.export.load(path).module()
    rng = np.random.RandomState(0)
    frames = [tuple(torch.from_numpy(rng.randn(1, 384, 1248, 3).astype(np.float32)).to(dev) for _ in range(2))
              for _ in range(2)]
    counters = (conv_soft_argmin_sm90, conv_soft_argmin_sm90_repitch, conv_soft_argmin_sm90_f32,
                conv_soft_argmin_sm90_f32_repitch, soft_argmin_cuda)
    n = [f.launches for f in counters]
    with torch.inference_mode():
        got = [prog(left, right) for left, right in frames]
    assert [f.launches - k for f, k in zip(counters, n)] == [len(frames), 0, 0, 0, 0]
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
def test_sharded_forward_on_one_shard_is_unsharded(dev, maxdisp):
    """``cost_volume_pspec`` without a mesh runs the slab path on one shard:
    halo-padded convolutions, the sharded resize and head, no head kernel.
    In fp32 it equals the plain-head forward bit for bit."""
    rng = np.random.RandomState(0)
    left, right = (torch.from_numpy(rng.randn(1, 96, 192, 3).astype(np.float32)).to(dev) for _ in range(2))
    plain = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="float32", pallas_head=False))
    sharded = best_sceneflow_model(LEAStereoConfig(maxdisp=maxdisp, compute_dtype="float32",
                                                   cost_volume_pspec=("data", "disp")))
    sharded.load_state_dict(plain.state_dict())
    counts = (conv_soft_argmin_sm90.launches, conv_soft_argmin_sm90_f32.launches, soft_argmin_cuda.launches)
    with torch.inference_mode():
        want, got = plain(left, right), sharded(left, right)
    assert (conv_soft_argmin_sm90.launches, conv_soft_argmin_sm90_f32.launches, soft_argmin_cuda.launches) == counts
    assert torch.isfinite(got).all() and torch.equal(got, want)
