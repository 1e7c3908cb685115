"""The port's parallel runs on the CPU (``leastereo_tpu_torch/parallel``):
ranks are processes joined over gloo (``tests/torch_parallel_worker.py``,
one intra-op thread each, no JAX in them).

* the halo exchange (``fetch_planes``) on even and uneven partitions, and
  the sharded heads and resize against their unsharded versions;
* one data-parallel supernet weight step on 2 ranks against the port's
  one-process step on the global batch;
* ``data/pipeline.py``'s per-process rows against JAX ``batch_iterator``;
* the mesh flags of the drivers' parsers and ``make_mesh`` without a group.
"""

import types

import numpy as np
import pytest
import torch

from torch_parallel_worker import run_ranks

from leastereo_tpu_torch.ops.resize import resize3d
from leastereo_tpu_torch.ops.softargmin import disparity_entropy, soft_argmin
from leastereo_tpu_torch.parallel import DispPartition, make_mesh

WORLD = 3
# 9 planes split 3, 3, 3; 10 split 4, 3, 3 (np.array_split). Each depth is
# resized down and up, at the model's odd/even scale rules.
DEPTHS = (9, 10)
SIZES = {9: [(5, 4, 5), (17, 8, 9)], 10: [(5, 4, 5), (20, 9, 11)]}
HALO = 2  # fetch_planes asks for two planes beyond each end
# fp32 sums in another order (per shard, then across ranks).
TOL_PX = 2e-5
TOL_ENTROPY = 1e-6
TOL_RESIZE = 2e-6

# One supernet weight step (SGD), 2 ranks of 2 rows against 1 process of 4.
# The loss and metrics agree to 1e-5 (measured 7e-7). The gradients of a
# train-mode BN net at this size are chaotically conditioned in fp32 (see
# tests/test_torch_train_grad.py): the one-process step on the same batch
# with its rows in another order, equal in exact arithmetic, already moves
# the gradients by 2.7e-3 relative L2 over all tensors (worst tensor 0.098,
# median 1.8e-3). So gradients and parameter updates are held to that noise
# floor, measured in the test: within 2x of the reordered run's relative L2
# over all tensors, its median and its worst, plus 1e-4 on each worst.
SEARCH = dict(maxdisp=24, h=24, w=48, batch=4, lr=0.5)
TOL_METRICS = 1e-5
TOL_NOISE_FACTOR, TOL_NOISE_ABS = 2.0, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exchange(tmp_path_factory):
    rng = np.random.RandomState(0)
    inp = {"disp": WORLD, "depths": DEPTHS, "sizes": SIZES}
    for d in DEPTHS:
        inp[f"vol{d}"] = rng.randn(2, 3, d, 6, 7).astype(np.float32)
        inp[f"cost{d}"] = (3 * rng.randn(2, d, 4, 5)).astype(np.float32)
    return inp, run_ranks(tmp_path_factory.mktemp("exchange"), WORLD, "exchange", **inp)


def test_partition_splits_as_array_split():
    for depth, world in ((136, 4), (34, 4), (17, 4), (10, 3), (16, 2)):
        part = DispPartition(depth, world)
        want = [(int(a[0]), int(a[-1]) + 1) for a in np.array_split(np.arange(depth), world)]
        assert part.bounds == want
    with pytest.raises(ValueError, match="needs a plane"):
        DispPartition(3, 4)


@pytest.mark.parametrize("depth", DEPTHS)
def test_fetch_planes(exchange, depth):
    inp, outs = exchange
    vol = torch.from_numpy(inp[f"vol{depth}"])
    padded = torch.nn.functional.pad(vol, (0, 0, 0, 0, HALO, HALO))
    for rank, (lo, hi) in enumerate(DispPartition(depth, WORLD).bounds):
        assert torch.equal(outs[rank][f"fetch{depth}"], padded[:, :, lo : hi + 2 * HALO]), rank


@pytest.mark.parametrize("depth", DEPTHS)
def test_sharded_heads_match_plain(exchange, depth):
    inp, outs = exchange
    cost = torch.from_numpy(inp[f"cost{depth}"])
    want, want_e = soft_argmin(cost, 3 * depth), disparity_entropy(cost, 3 * depth)
    assert want.std() > 1.0
    for rank in range(WORLD):
        np.testing.assert_allclose(outs[rank][f"softargmin{depth}"], want, rtol=0, atol=TOL_PX)
        np.testing.assert_allclose(outs[rank][f"entropy{depth}"], want_e, rtol=0, atol=TOL_ENTROPY)


@pytest.mark.parametrize("depth,which", [(d, i) for d in DEPTHS for i in (0, 1)])
def test_sharded_resize3d(exchange, depth, which):
    inp, outs = exchange
    size = SIZES[depth][which]
    want = resize3d(torch.from_numpy(inp[f"vol{depth}"]), size)
    got = torch.cat([o[f"resize{depth}_{size[0]}"] for o in outs], dim=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_RESIZE)


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got - want) / max(torch.linalg.vector_norm(want), 1e-30))


def check_within_noise(got: dict, want: dict, reordered: dict, what: str) -> None:
    """``got`` (per-tensor, the data-parallel step) against ``want`` (the
    one-process step) within the fp32 noise floor that ``reordered`` (the
    one-process step on the same rows in another order) shows against it."""
    assert got.keys() == want.keys() == reordered.keys()
    names = sorted(want)

    def flat(d):
        return torch.cat([d[n].double().flatten() for n in names])

    rel = {n: _rel_l2(got[n], want[n]) for n in names}
    noise = {n: _rel_l2(reordered[n], want[n]) for n in names}
    measured = {
        "all": (_rel_l2(flat(got), flat(want)), _rel_l2(flat(reordered), flat(want))),
        "median": (float(np.median(list(rel.values()))), float(np.median(list(noise.values())))),
        "worst": (max(rel.values()), max(noise.values())),
    }
    print(f"{what}: rel L2 (data-parallel, reordered rows) {measured}")
    for k, (dp, floor) in measured.items():
        assert dp <= TOL_NOISE_FACTOR * floor + (TOL_NOISE_ABS if k == "worst" else 1e-6), (what, k, dp, floor)


def search_step_outputs(kw: dict, sd: dict, batch: dict, order) -> tuple[dict, dict, dict]:
    """One-process weight step on ``batch``'s rows in ``order``: metrics,
    gradients, state."""
    from leastereo_tpu_torch.search import AutoStereoSupernet, make_weight_optimizer, weight_step

    model = AutoStereoSupernet(**kw)
    model.load_state_dict({k: v.clone() for k, v in sd.items()})
    opt = make_weight_optimizer(model.weight_parameters(), SEARCH["lr"])
    m = weight_step(model, opt, {k: v[order] for k, v in batch.items()}, SEARCH["maxdisp"], SEARCH["lr"])
    return m, {n: p.grad for n, p in model.named_parameters() if p.grad is not None}, model.state_dict()


def test_search_weight_step_data_parallel(tmp_path):
    from leastereo_tpu_torch.search import AutoStereoSupernet, SupernetConfig

    kw = dict(maxdisp=SEARCH["maxdisp"], fea=SupernetConfig(4, 2, 4, 3), mat=SupernetConfig(4, 2, 4, 3),
              dtype=torch.float32)
    sd = {k: v.clone() for k, v in AutoStereoSupernet(**kw, generator=torch.Generator().manual_seed(0))
          .state_dict().items()}
    rng = np.random.RandomState(1)
    b, h, w = SEARCH["batch"], SEARCH["h"], SEARCH["w"]
    target = (rng.rand(b, h, w) * 30).astype(np.float32)  # ~20% at or above maxdisp 24
    target[2:, : h // 2] = 40.0  # rank 1's rows: fewer valid pixels
    batch = {"left": rng.randn(b, h, w, 3).astype(np.float32), "right": rng.randn(b, h, w, 3).astype(np.float32),
             "disparity": target}

    want, grads, state = search_step_outputs(kw, sd, batch, [0, 1, 2, 3])
    _, grads_r, state_r = search_step_outputs(kw, sd, batch, [2, 3, 0, 1])
    outs = run_ranks(tmp_path, 2, "search_step", data=2, supernet=kw, state_dict=sd, batch=batch, lr=SEARCH["lr"])
    params = [n for n in grads]
    stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
    for out in outs:
        for k in ("loss", "epe", "err3"):
            np.testing.assert_allclose(out["metrics"][k], want[k], rtol=TOL_METRICS, err_msg=k)
        check_within_noise(out["grads"], grads, grads_r, "gradients")
        check_within_noise(*({n: s[n] - sd[n] for n in params} for s in (out["state"], state, state_r)), "updates")
        check_within_noise(*({k: s[k] for k in stats} for s in (out["state"], state, state_r)), "BN stats")
        assert all(torch.equal(out["state"][k], state[k]) for k in state if k.endswith("num_batches_tracked"))
        assert torch.equal(out["state"]["feature.alphas"], sd["feature.alphas"])  # arch params do not move
    assert all(torch.equal(outs[0]["state"][k], outs[1]["state"][k]) for k in state)  # replicas stay equal


class _FakeDataset:
    """Numbered samples for both packages' ``batch_iterator``."""

    def __len__(self):
        return 12

    def __getitem__(self, i, epoch=0):
        v = np.full((2, 3), 100 * epoch + i, np.float32)
        return types.SimpleNamespace(left=v, right=v + 0.5, disparity=v[..., 0])


@pytest.mark.parametrize("count", [2, 4])
def test_pipeline_rows_match_jax(count):
    from leastereo_tpu.data.pipeline import batch_iterator as jax_batches

    from leastereo_tpu_torch.data import batch_iterator

    ds = _FakeDataset()
    for epoch in (0, 1):
        rows = []
        for index in range(count):
            it = dict(shuffle=True, epoch=epoch, seed=7, num_workers=0, process_index=index, process_count=count)
            got, want = list(batch_iterator(ds, 4, **it)), list(jax_batches(ds, 4, **it))
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert g["left"].shape[0] == 4 // count
                assert all(np.array_equal(g[k], w[k]) for k in w)
            rows.append(np.concatenate([g["left"][:, 0, 0] for g in got]))
        # Together the processes load every sample of the epoch once.
        assert sorted(np.concatenate(rows) - 100 * epoch) == list(range(12))
    with pytest.raises(ValueError, match="not divisible"):
        next(batch_iterator(ds, 4, process_index=0, process_count=3))


@pytest.mark.parametrize("parser", ["train_parser", "search_parser", "predict_parser", "evaluate_parser"])
def test_mesh_flags_on_parsers(parser):
    from leastereo_tpu_torch.cli import config

    base = ["--listset", "x", "--crop_height", "12", "--crop_width", "24"]
    args = getattr(config, parser)().parse_args(base)
    assert (args.mesh_data, args.mesh_disp, args.multihost) == (None, 1, False)
    args = getattr(config, parser)().parse_args(base + ["--mesh_data", "2", "--mesh_disp", "4", "--multihost"])
    assert (args.mesh_data, args.mesh_disp, args.multihost) == (2, 4, True)


def test_mesh_without_process_group():
    mesh = make_mesh()
    assert (mesh.data, mesh.disp, mesh.rank, mesh.data_group, mesh.disp_group) == (1, 1, 0, None, None)
    assert mesh.shape == {"data": 1, "disp": 1}
    with pytest.raises(ValueError, match="needs more than 1 ranks"):
        make_mesh(data=1, disp=2)


def test_process_setup_without_a_group(monkeypatch):
    from leastereo_tpu_torch.parallel import initialize, local_batch_size, make_global_batch, process_info

    assert process_info() == (0, 1) and local_batch_size(4) == 4
    batch = make_global_batch({"left": np.ones((2, 3), np.float64), "disparity": torch.zeros(2)}, "cpu")
    assert batch["left"].dtype == torch.float32 and batch["left"].shape == (2, 3)
    for k in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        initialize(num_processes=1, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="nccl carries CUDA tensors only"):
        initialize("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
    # A rank without a card of its own raises; it never moves to the CPU.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="wants card 1"):
        initialize("127.0.0.1:1", 2, 1, backend="gloo", device="cuda")
