"""The backward of the port's disparity-sharded ops on gloo ranks of the CPU
(``tests/torch_parallel_worker.py`` ``task_adjoint``), in float64: the
gradient each rank's slab receives through ``fetch_planes`` (the halo
exchange's adjoint), ``halo``, the sharded ``resize3d`` and the two sharded
soft-argmins equals that slab of the unsharded op's gradient within 1e-10,
on 2 ranks (9 planes: 5, 4) and 3 ranks (10 planes: 4, 3, 3).

The soft-argmins return the whole map on every rank and every rank takes
the same loss from it; their sums pass each rank its own gradient, so a
slab's gradient is its share of the loss's gradient, not ``world`` times it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leastereo_tpu_torch.ops.resize import resize3d
from leastereo_tpu_torch.ops.softargmin import soft_argmin, soft_argmin_fast
from leastereo_tpu_torch.parallel import DispPartition
from torch_parallel_worker import run_ranks

TOL = 1e-10  # float64 sums in another order
# world -> (depth, resized depths): each resized down and up at the model's rules.
CASES = {2: (9, [(5, 4, 5), (17, 8, 9)]), 3: (10, [(5, 4, 5), (20, 9, 11)])}
OPS = ("fetch", "halo", "softargmin", "fast", "resize0", "resize1")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unsharded_grads(inp: dict, depth: int, world: int) -> dict:
    """The gradient of ``sum over ranks of sum(out_r * g_r)`` of each op,
    unsharded, for the volume or cost of the whole depth."""
    vol, cost = (torch.from_numpy(inp[k]).requires_grad_() for k in (f"vol{depth}", f"cost{depth}"))
    bounds = DispPartition(depth, world).bounds

    def g(name):
        return torch.from_numpy(inp[f"g_{name}{depth}"])

    out = {}
    for name, (x, loss) in {
        "fetch": (vol, lambda: sum((F.pad(vol, (0, 0, 0, 0, 2, 2))[:, :, a : b + 4] * g("fetch")[:, :, a : b + 4]).sum()
                                   for a, b in bounds)),
        "halo": (vol, lambda: sum((F.pad(vol, (0, 0, 0, 0, 1, 1))[:, :, a : b + 2] * g("halo")[:, :, a : b + 2]).sum()
                                  for a, b in bounds)),
        "softargmin": (cost, lambda: (soft_argmin(cost, 3 * depth) * g("softargmin")).sum()),
        "fast": (cost, lambda: (soft_argmin_fast(cost, 3 * depth) * g("fast")).sum()),
        **{f"resize{i}": (vol, lambda s=s: (resize3d(vol, s) * g(f"resize{s[0]}")).sum())
           for i, s in enumerate(inp["sizes"][depth])},
    }.items():
        x.grad = None
        loss().backward()
        out[name] = x.grad.clone()
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def adjoints(request, tmp_path_factory):
    world = request.param
    depth, sizes = CASES[world]
    rng = np.random.RandomState(world)
    b, c, h, w = 2, 3, 4, 5
    inp = {"disp": world, "depths": [depth], "sizes": {depth: sizes},
           f"vol{depth}": rng.randn(b, c, depth, h, w), f"cost{depth}": 3 * rng.randn(b, depth, h, w),
           f"g_fetch{depth}": rng.randn(b, c, depth + 4, h, w), f"g_halo{depth}": rng.randn(b, c, depth + 2, h, w),
           f"g_softargmin{depth}": rng.randn(b, 3 * h, 3 * w), f"g_fast{depth}": rng.randn(b, 3 * h, 3 * w)}
    for s in sizes:
        inp[f"g_resize{s[0]}{depth}"] = rng.randn(b, c, *s)
    outs = run_ranks(tmp_path_factory.mktemp(f"adjoint{world}"), world, "adjoint", **inp)
    return world, depth, sizes, outs, unsharded_grads(inp, depth, world)


@pytest.mark.parametrize("op", OPS)
def test_sharded_gradient_is_the_slab_of_the_unsharded_one(adjoints, op):
    world, depth, sizes, outs, want = adjoints
    key = op if not op.startswith("resize") else f"resize{sizes[int(op[-1])][0]}"
    full = want[op]
    dim = 1 if op in ("softargmin", "fast") else 2
    assert full.abs().max() > 0
    for rank, out in enumerate(outs):
        part = DispPartition(depth, world, rank)
        got, ref = out[f"{key}{depth}"], full.narrow(dim, part.lo, part.count)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL, err_msg=f"{op} rank {rank}")
        if op in ("softargmin", "fast"):
            # Counted once: not the world-fold gradient an all_reduce adjoint gives.
            ratio = float(got.norm() / ref.norm())
            assert abs(ratio - 1.0) < 1e-9, ratio
