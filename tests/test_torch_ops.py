"""The port's plain ops (leastereo_tpu_torch/ops) against their JAX
counterparts, on the same numpy-seeded inputs, in fp32 on the CPU.

JAX functions take NHWC / NDHWC tensors and the port NCHW / NCDHW: each test
transposes at the boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leastereo_tpu.ops import convbr as j_convbr
from leastereo_tpu.ops import cost_volume as j_cv
from leastereo_tpu.ops import fused_stem as j_fs
from leastereo_tpu.ops import resize as j_resize
from leastereo_tpu.ops import softargmin as j_sa
from leastereo_tpu_torch.ops import resize
from leastereo_tpu_torch.ops.convbr import ConvBR
from leastereo_tpu_torch.ops.cost_volume import build_cost_volume
from leastereo_tpu_torch.ops.fused_stem import fused_cost_volume_stem, stem_ndhwc_cuda
from leastereo_tpu_torch.ops.layout import cat_channels, cat_ndhwc_cuda, is_ndhwc
from leastereo_tpu_torch.ops.softargmin import disparity_entropy, soft_argmin, soft_argmin_fast
from leastereo_tpu_torch.utils.weights import state_dict_from_jax


# fp32 on both sides, same algebra, different summation order.
TOL = dict(rtol=1e-5, atol=1e-5)


def _last_to_first(a):  # N...C -> NC...
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _first_to_last(t):  # NC... -> N...C
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.mark.parametrize("dim,scale", [(7, 2.0), (8, 2.0), (7, 0.5), (8, 0.5), (13, 0.5)])
def test_scale_dimension(dim, scale):
    assert resize.scale_dimension(dim, scale) == j_resize.scale_dimension(dim, scale)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("ndim,src,dst", [(2, (5, 7), (9, 13)), (2, (8, 12), (4, 6)), (3, (4, 5, 6), (7, 9, 11))])
def test_resize_matches_jax(ndim, src, dst, align):
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    fn_j = j_resize.resize2d if ndim == 2 else j_resize.resize3d
    fn_t = resize.resize2d if ndim == 2 else resize.resize3d
    ref = np.asarray(fn_j(jnp.asarray(x), dst, align_corners=align))
    got = _first_to_last(fn_t(_last_to_first(x), dst, align_corners=align))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("axis", [1, 2, 3])
def test_upsample3x_axis_matches_jax(axis):
    x = np.random.RandomState(1).randn(2, 4, 5, 6).astype(np.float32)
    ref = np.asarray(j_resize.upsample3x_axis(jnp.asarray(x), axis))
    got = resize.upsample3x_axis(torch.from_numpy(x), axis).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def _perturb_bn(variables, rng):
    """Move BN scale/bias/mean/var off their init so the fold is exercised."""
    out = jax.tree_util.tree_map(np.asarray, variables)
    bn_p, bn_s = out["params"]["bn"], out["batch_stats"]["bn"]
    c = bn_p["scale"].shape
    bn_p["scale"] = (1 + 0.3 * rng.randn(*c)).astype(np.float32)
    bn_p["bias"] = (0.2 * rng.randn(*c)).astype(np.float32)
    bn_s["mean"] = (0.2 * rng.randn(*c)).astype(np.float32)
    bn_s["var"] = np.exp(0.5 * rng.randn(*c)).astype(np.float32)
    return out


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize(
    "ndim,shape,cin,cout,k,stride,pad",
    [
        (2, (2, 12, 15), 4, 8, 3, 3, 1),  # stride-3 stem1: torch-style symmetric padding
        (2, (1, 6, 7), 8, 5, 1, 1, 0),
        (3, (1, 4, 6, 7), 4, 6, 3, 1, 1),
    ],
)
def test_convbr_matches_jax(ndim, shape, cin, cout, k, stride, pad, train):
    rng = np.random.RandomState(2)
    x = rng.randn(*shape, cin).astype(np.float32)
    mod = j_convbr.ConvBR(cout, (k,) * ndim, stride, pad, dtype=jnp.float32)
    variables = _perturb_bn(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    if train:
        ref, _ = mod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = mod.apply(variables, jnp.asarray(x))
    port = ConvBR(cin, cout, k, stride, pad, ndim=ndim)
    port.load_state_dict(state_dict_from_jax(variables))
    port.train(train)
    with torch.no_grad():
        got = _first_to_last(port(_last_to_first(x)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("num_disp", [1, 4, 9])
def test_build_cost_volume_matches_jax(num_disp):
    rng = np.random.RandomState(3)
    left = rng.randn(2, 5, 8, 3).astype(np.float32)
    right = rng.randn(2, 5, 8, 3).astype(np.float32)
    ref = np.asarray(j_cv.build_cost_volume(jnp.asarray(left), jnp.asarray(right), num_disp))
    got = _first_to_last(build_cost_volume(_last_to_first(left), _last_to_first(right), num_disp))
    np.testing.assert_array_equal(got, ref)


def _cost(b, d, h, w, seed):
    rng = np.random.RandomState(seed)
    best = rng.randint(0, d, size=(b, 1, h, w))
    return (0.35 * np.abs(np.arange(d)[None, :, None, None] - best) + 0.8 * rng.randn(b, d, h, w)).astype(
        np.float32
    )


@pytest.mark.parametrize("fn", ["soft_argmin", "soft_argmin_fast", "disparity_entropy"])
def test_heads_match_jax(fn):
    b, d, h, w = 2, 8, 5, 7
    cost = _cost(b, d, h, w, seed=4)
    ref = np.asarray(getattr(j_sa, fn)(jnp.asarray(cost)[..., None], 3 * d))
    port = {"soft_argmin": soft_argmin, "soft_argmin_fast": soft_argmin_fast, "disparity_entropy": disparity_entropy}
    got = port[fn](torch.from_numpy(cost), 3 * d).numpy()
    assert got.shape == (b, 3 * h, 3 * w)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize(
    "b,h,w,c,f,num_disp",
    [
        (1, 8, 12, 4, 6, 5),
        (1, 6, 9, 3, 4, 9),  # num_disp == w: the diagonal reaches the full width
        (1, 4, 6, 2, 2, 1),  # single disparity: both depth pads clip
        (1, 4, 6, 2, 2, 10),  # num_disp > w
    ],
)
def test_fused_stem_matches_jax_and_volume_conv(b, h, w, c, f, num_disp, epilogue):
    rng = np.random.RandomState(5)
    left = rng.randn(b, h, w, c).astype(np.float32)
    right = rng.randn(b, h, w, c).astype(np.float32)
    kernel = rng.randn(3, 3, 3, 2 * c, f).astype(np.float32)  # DHWIO
    bias = rng.randn(f).astype(np.float32) if epilogue else None

    ref = j_fs.fused_cost_volume_stem(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(kernel), num_disp,
        bias=None if bias is None else jnp.asarray(bias), relu=epilogue,
    )
    lt, rt = _last_to_first(left), _last_to_first(right)
    kt = torch.from_numpy(np.ascontiguousarray(kernel.transpose(4, 3, 0, 1, 2)))  # OIDHW
    bt = None if bias is None else torch.from_numpy(bias)
    got = fused_cost_volume_stem(lt, rt, kt, num_disp, bias=bt, relu=epilogue)
    np.testing.assert_allclose(_first_to_last(got), np.asarray(ref), rtol=1e-4, atol=1e-4)

    own = F.conv3d(build_cost_volume(lt, rt, num_disp), kt, bt, padding=1)
    if epilogue:
        own = torch.relu(own)
    torch.testing.assert_close(got, own, rtol=1e-4, atol=1e-4)


NDHWC = torch.channels_last_3d


@pytest.mark.parametrize("src,dst", [((4, 5, 6), (7, 9, 11)), ((8, 6, 10), (16, 12, 20)), ((7, 9, 11), (4, 5, 6)),
                                     ((16, 12, 20), (8, 6, 10)), ((5, 6, 7), (9, 12, 3))])
def test_resize3d_keeps_ndhwc(src, dst):
    """An NDHWC volume resizes to an NDHWC volume with ``F.interpolate``'s values."""
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 8, *src).astype(np.float32))
    got = resize.resize3d(x.contiguous(memory_format=NDHWC), dst)
    assert is_ndhwc(got)
    torch.testing.assert_close(got, F.interpolate(x, size=dst, mode="trilinear", align_corners=True),
                               rtol=1e-6, atol=1e-6)


def test_ndhwc_resize_kernel_scales_and_refusals():
    """The resize kernel's scales are PyTorch's (float32 division, 0 for one
    output); the NDHWC kernels' wrappers refuse CPU and NCDHW volumes."""
    for n_in, n_out in ((17, 34), (64, 32), (68, 136), (9, 5), (3, 1)):
        want = (torch.tensor(float(n_in - 1)) / (n_out - 1)).item() if n_out > 1 else 0.0
        assert resize._align_corners_scale(n_in, n_out, torch.float32) == want
        assert resize._align_corners_scale(n_in, n_out, torch.float64) == (
            (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0)
    x = torch.zeros(1, 8, 3, 4, 5)
    for vol in (x, x.contiguous(memory_format=NDHWC)):
        with pytest.raises(ValueError, match="NDHWC CUDA volume"):
            resize.resize3d_ndhwc_cuda(vol, (5, 6, 7))
        with pytest.raises(ValueError, match="NDHWC cat"):
            cat_ndhwc_cuda([vol, vol])
    with pytest.raises(ValueError, match="NDHWC stem"):
        stem_ndhwc_cuda(torch.zeros(1, 120, 8), torch.zeros(1, 32, 8), torch.zeros(1, 3, 4, 8), None, True,
                        [(0, 1, 2)], (0, 3), 3, 4, 5)


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("b,h,w,c,f,num_disp,planes",
                         [(1, 8, 12, 4, 6, 5, None), (2, 6, 9, 3, 4, 9, None), (1, 4, 6, 2, 2, 10, (3, 8))])
def test_fused_stem_writes_ndhwc(b, h, w, c, f, num_disp, planes, epilogue):
    """``memory_format=channels_last_3d``: the same values, laid out NDHWC."""
    rng = np.random.RandomState(7)
    left, right = (torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)) for _ in range(2))
    kernel = torch.from_numpy(rng.randn(f, 2 * c, 3, 3, 3).astype(np.float32))
    bias = torch.from_numpy(rng.randn(f).astype(np.float32)) if epilogue else None
    kw = dict(bias=bias, relu=epilogue, planes=planes)
    want = fused_cost_volume_stem(left, right, kernel, num_disp, **kw)
    got = fused_cost_volume_stem(left, right, kernel, num_disp, memory_format=NDHWC, **kw)
    assert is_ndhwc(got) and want.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bn,relu,k", [(True, True, 3), (True, True, 1), (False, False, 3), (True, False, 1)])
def test_convbr_eval_routes(bn, relu, k):
    """A 3-D eval ConvBR keeps its input's layout and counts its route; the
    same values either way; training and 2-D convolutions count none."""
    rng = np.random.RandomState(8)
    conv = ConvBR(6, 8, k, 1, k // 2, ndim=3, bn=bn, relu=relu)
    if bn:
        conv.bn.running_mean.normal_(0, 0.2)
        conv.bn.running_var.uniform_(0.5, 2.0)
    x = torch.from_numpy(rng.randn(2, 6, 5, 7, 9).astype(np.float32))
    before = dict(ConvBR.eval_routes)
    with torch.no_grad():
        want = conv.eval()(x)
        got = conv(x.contiguous(memory_format=NDHWC))
        conv.train()(x)
        ConvBR(6, 8, 3, 1, 1, ndim=2).eval()(x[:, :, 0])
    delta = {k: v - before[k] for k, v in ConvBR.eval_routes.items()}
    assert delta == {"ndhwc_sm90": 0, "ndhwc_fused": 0, "ndhwc": 1, "ncdhw": 1}
    assert is_ndhwc(got) and want.is_contiguous()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("channels", [(8, 8), (16, 16, 16, 16), (32, 64), (3, 5)])
def test_cat_channels(channels):
    """NDHWC volumes join along C into an NDHWC volume, NCDHW ones into an
    NCDHW one, with ``torch.cat``'s values either way."""
    rng = np.random.RandomState(11)
    xs = [torch.from_numpy(rng.randn(2, c, 3, 4, 5).astype(np.float32)) for c in channels]
    want = torch.cat(xs, dim=1)
    got = cat_channels([x.contiguous(memory_format=NDHWC) for x in xs])
    assert is_ndhwc(got) and torch.equal(got, want)
    assert cat_channels(xs).is_contiguous() and torch.equal(cat_channels(xs), want)
