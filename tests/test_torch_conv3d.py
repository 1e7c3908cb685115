"""The sm90 3x3x3 eval convolution (``ops/conv3d.py``, ``csrc/conv3d_sm90.cu``)
on the CPU: the gate ``ConvBR.eval_conv`` routes by, the route it counts, and
a replay of the kernel's decomposition (its tiles, runs of planes and ring
of haloed input planes, the per-tap products of shifted views, fp32 sums,
bias, ReLU, one bf16 rounding) against ``F.conv3d`` in float64 for each
instantiated class at tiny volumes whose h and w are not multiples of the
tile. The kernel itself runs on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leastereo_tpu_torch.ops import _build
from leastereo_tpu_torch.ops import convbr as convbr_mod
from leastereo_tpu_torch.ops.conv3d import conv3d_bias_relu_plain, conv3d_bias_relu_sm90, conv3d_sm90_admits
from leastereo_tpu_torch.ops.convbr import ConvBR

NDHWC = torch.channels_last_3d


class OnCard:
    """A CPU tensor that reports the card as its device: the gate reads only
    what a call shows (device, type, layout, shape), never the data."""

    device = torch.device("cuda")

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def _volume(cin, dtype=torch.bfloat16, layout=NDHWC, dhw=(3, 4, 5)):
    return torch.zeros(1, cin, *dhw, dtype=dtype).contiguous(memory_format=layout)


# (change from an admitted call, admitted): device, type, layout, kernel,
# stride, padding (depth_pad False drops the depth padding), bias, ReLU,
# channels.
GATE_CASES = [
    ({}, True),
    ({"cin": 8, "cout": 8}, True),
    ({"cin": 32, "cout": 32}, True),
    ({"device": "cpu"}, False),
    ({"dtype": torch.float32}, False),
    ({"dtype": torch.float16}, False),
    ({"layout": torch.contiguous_format}, False),
    ({"k": 1}, False),
    ({"stride": (1, 2, 2)}, False),
    ({"padding": (0, 1, 1)}, False),
    ({"padding": (2, 2, 2)}, False),
    ({"bias": False}, False),
    ({"relu": False}, False),
    ({"cin": 16, "cout": 8}, False),
    ({"cin": 24, "cout": 24}, False),
    ({"cin": 64, "cout": 64}, False),
    ({"cin": 128, "cout": 64}, False),  # cuDNN's fused route is faster there (PERF.md)
]


@pytest.mark.parametrize("change,admitted", GATE_CASES)
def test_conv3d_sm90_gate(change, admitted):
    """The gate admits exactly a CUDA NDHWC bf16 volume under a 3x3x3 kernel
    of stride 1 and padding 1 with a bias and a ReLU, of an instantiated
    (C_in, C_out) class; each departure alone sends the call elsewhere."""
    a = {"device": "cuda", "dtype": torch.bfloat16, "layout": NDHWC, "k": 3, "stride": (1, 1, 1),
         "padding": (1, 1, 1), "bias": True, "relu": True, "cin": 16, "cout": 16, **change}
    x = _volume(a["cin"], a["dtype"], a["layout"])
    x = OnCard(x) if a["device"] == "cuda" else x
    weight = torch.zeros(a["cout"], a["cin"], a["k"], a["k"], a["k"], dtype=a["dtype"])
    bias = torch.zeros(a["cout"], dtype=a["dtype"]) if a["bias"] else None
    assert conv3d_sm90_admits(x, weight, bias, a["relu"], a["stride"], a["padding"]) is admitted


def _convbr(cin, cout, k=3, seed=0, **kw):
    conv = ConvBR(cin, cout, k, 1, k // 2, ndim=3, generator=torch.Generator().manual_seed(seed), **kw).eval()
    if conv.bn is not None:
        conv.bn.running_mean.normal_(0, 0.2)
        conv.bn.running_var.uniform_(0.5, 2.0)
    return conv


@pytest.mark.parametrize("cin,cout", sorted(_build.CONV3D_SM90_TILES))
def test_eval_conv_routes_admitted_card_volumes_to_the_kernel(monkeypatch, cin, cout):
    """An admitted card volume goes to the kernel's wrapper, with the folded
    kernel laid out channels_last_3d in bf16 and the bias in bf16, and counts
    ``ndhwc_sm90``; without depth padding (a haloed slab) it does not."""
    calls = []
    monkeypatch.setattr(convbr_mod, "conv3d_bias_relu_sm90", lambda *args: calls.append(args) or "kernel")
    conv = _convbr(cin, cout)
    x = OnCard(_volume(cin))
    before = dict(ConvBR.eval_routes)
    assert conv.eval_conv(x, relu=True) == "kernel"
    assert {r: v - before[r] for r, v in ConvBR.eval_routes.items()} == {
        "ndhwc_sm90": 1, "ndhwc_fused": 0, "ndhwc": 0, "ncdhw": 0}
    (got_x, weight, bias), = calls
    assert got_x is x and weight.dtype == bias.dtype == torch.bfloat16
    assert weight.shape == (cout, cin, 3, 3, 3) and weight.is_contiguous(memory_format=NDHWC)
    w, b = conv.folded()
    assert torch.equal(weight, w.to(torch.bfloat16)) and torch.equal(bias, b.to(torch.bfloat16))
    weight, _ = conv.folded()
    assert not conv3d_sm90_admits(x, weight, b, True, conv.conv.stride, (0, 1, 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eval_conv_on_the_cpu_keeps_its_route(dtype):
    """On the CPU an NDHWC ConvBR of an admitted class stays on the unfused
    NDHWC route and the kernel's launch count does not move."""
    conv = _convbr(16, 16, seed=1)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 16, 3, 5, 6).astype(np.float32)).to(dtype)
    before, launches = dict(ConvBR.eval_routes), conv3d_bias_relu_sm90.launches
    with torch.no_grad():
        got = conv(x.contiguous(memory_format=NDHWC))
    assert {r: v - before[r] for r, v in ConvBR.eval_routes.items()} == {
        "ndhwc_sm90": 0, "ndhwc_fused": 0, "ndhwc": 1, "ncdhw": 0}
    assert conv3d_bias_relu_sm90.launches == launches and got.is_contiguous(memory_format=NDHWC)


def test_wrapper_on_the_cpu_is_the_plain_version():
    """Given CPU tensors the wrapper returns its plain version (fp32 sums,
    bias and ReLU, one rounding, NDHWC) and counts no launch."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 8, 3, 4, 5).astype(np.float32)).to(torch.bfloat16)
    x = x.contiguous(memory_format=NDHWC)
    w = torch.from_numpy(0.2 * rng.randn(8, 8, 3, 3, 3).astype(np.float32)).to(torch.bfloat16, memory_format=NDHWC)
    b = torch.from_numpy(rng.randn(8).astype(np.float32)).to(torch.bfloat16)
    launches = conv3d_bias_relu_sm90.launches
    got = conv3d_bias_relu_sm90(x, w, b)
    assert conv3d_bias_relu_sm90.launches == launches
    assert torch.equal(got, conv3d_bias_relu_plain(x, w, b)) and got.is_contiguous(memory_format=NDHWC)


def replay(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, run: int) -> torch.Tensor:
    """The kernel's decomposition on the CPU for an NDHWC bf16 volume
    ``(N, C_in, D, H, W)``: a block per (TH x TW tile, run of output planes);
    its ring of ``STAGES`` slots takes input planes d0 - 1 .. d0 + run (the
    haloed (TH + 2) x (TW + 2) box, zeros outside the volume, as the tensor
    map's fill) in order, slot i % STAGES, reloading a slot once the output
    plane that last reads it is done; each output plane sums, in fp32, the 27
    taps' products of the slot seen at the tap's offset with the tap's
    C_in x C_out weights (C_in = 8: k-steps of two taps, a zero 28th tap),
    over the M-tiles of 16 voxels the warps own; then bias, ReLU, one bf16
    rounding, and the stores of the voxels inside the frame."""
    cin, cout = x.shape[1], weight.shape[0]
    th, tw, stages = _build.CONV3D_SM90_TILES[cin, cout]
    bh, bw = th + 2, tw + 2
    n_, _, d_, h_, w_ = x.shape
    xv = x.permute(0, 2, 3, 4, 1).float()  # (N, D, H, W, C): the tensor map's view, c fastest
    taps = weight.permute(2, 3, 4, 1, 0).reshape(27, cin, cout).float()  # [tap][ci][co]
    if cin == 8:  # k-steps of 16: taps (2p, 2p + 1), a zero 28th tap
        taps = torch.cat([taps, torch.zeros(1, cin, cout)]).reshape(14, 2 * cin, cout)
    out = torch.full((n_, d_, h_, w_, cout), float("nan"))

    def box(n, d, h0, w0):
        b = torch.zeros(bh, bw, cin)
        if 0 <= d < d_:
            hs, ws = slice(max(h0 - 1, 0), min(h0 - 1 + bh, h_)), slice(max(w0 - 1, 0), min(w0 - 1 + bw, w_))
            b[hs.start - (h0 - 1):hs.stop - (h0 - 1), ws.start - (w0 - 1):ws.stop - (w0 - 1)] = xv[n, d, hs, ws]
        return b

    rows, cols = th, tw  # output tile; M-tile t covers row t // (TW / 16), cols 16 (t % (TW / 16)) ..
    mtiles = th * tw // 16
    vox = torch.stack([torch.tensor([t // (tw // 16), t % (tw // 16) * 16 + i]) for t in range(mtiles)
                       for i in range(16)])  # (M, 2): (row, col) of each M-tile row, warp-major
    for n in range(n_):
        for d0 in range(0, d_, run):
            nout = min(d_ - d0, run)
            for h0 in range(0, h_, rows):
                for w0 in range(0, w_, cols):
                    slots, held = [None] * stages, [None] * stages
                    for i in range(min(stages, nout + 2)):
                        slots[i], held[i] = box(n, d0 - 1 + i, h0, w0), d0 - 1 + i
                    for j in range(nout):
                        planes = [slots[(j + kd) % stages] for kd in range(3)]
                        assert [held[(j + kd) % stages] for kd in range(3)] == [d0 + j - 1 + kd for kd in range(3)]
                        view = lambda tap: planes[tap // 9][vox[:, 0] + tap % 9 // 3, vox[:, 1] + tap % 3]  # noqa: E731
                        acc = torch.zeros(len(vox), cout)
                        if cin == 8:
                            for p in range(14):
                                a = torch.cat([view(2 * p), view(min(2 * p + 1, 26))], dim=1)
                                acc += a @ taps[p]
                        else:
                            for tap in range(27):
                                acc += view(tap) @ taps[tap]
                        y = torch.relu(acc + bias.float()).to(torch.bfloat16)
                        if j + stages < nout + 2:
                            slots[j % stages], held[j % stages] = box(n, d0 + j + stages - 1, h0, w0), d0 + j + stages - 1
                        h, w = h0 + vox[:, 0], w0 + vox[:, 1]
                        inside = (h < h_) & (w < w_)
                        out[n, d0 + j, h[inside], w[inside]] = y[inside].float()
    return out.to(torch.bfloat16).permute(0, 4, 1, 2, 3)


# (C_in, C_out, (D, H, W)): each class at a volume whose h and w are not
# multiples of its tile (two tiles in each), some runs of planes ragged too.
REPLAY_CASES = [(8, 8, (5, 19, 37)), (16, 16, (4, 21, 35)), (32, 32, (5, 21, 33)), (32, 32, (3, 19, 47))]


@pytest.mark.parametrize("cin,cout,dhw", REPLAY_CASES)
def test_kernel_decomposition_replay(cin, cout, dhw):
    """The replay of the kernel's decomposition, at runs of 1, 2 and all
    output planes, against float64 ``F.conv3d`` plus bias, ReLU: within one
    bf16 rounding (the fp32 sums are exact to far less), every voxel written."""
    rng = np.random.RandomState(cin + dhw[0])
    x = torch.from_numpy(np.maximum(rng.randn(1, cin, *dhw), 0).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(cout, cin, 3, 3, 3) / np.sqrt(27 * cin)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(0.3 * rng.randn(cout).astype(np.float32)).to(torch.bfloat16)
    pre = F.conv3d(x.double(), w.double(), padding=1) + b.double().view(1, -1, 1, 1, 1)
    exact = torch.relu(pre)
    plain = conv3d_bias_relu_plain(x.contiguous(memory_format=NDHWC), w.contiguous(memory_format=NDHWC), b)
    for run in (1, 2, dhw[0]):
        got = replay(x, w, b, run)
        assert torch.isfinite(got).all()
        err = (got.double() - exact).abs()
        assert (err <= 2 ** -8 * exact.abs() + 1e-6).all(), err.max().item()
        # The plain version rounds the same fp32 sums once: at most one bf16 step apart.
        assert ((got.double() - plain.double()).abs() <= 2 ** -7 * exact.abs() + 1e-6).all()
