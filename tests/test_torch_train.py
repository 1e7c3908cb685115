"""Training of the port (leastereo_tpu_torch/train, data/pipeline.py,
utils/experiment.py, utils/checkpoint.py, cli/train.py freeze_params) against
the JAX package, on the CPU.

The train-mode forward runs at the small config of tests/test_torch_model.py
(48x96, maxdisp 48, fp32) at batch 2, with that file's perturbed weights,
the ``last_3`` kernel rescaled on the train-mode cost, and a right view of
twice the left's spread, so pooled and per-view BN statistics differ.
"""

import copy
import functools
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leastereo_tpu.models import LEAStereoConfig as JaxConfig
from leastereo_tpu.models import best_sceneflow_model as jax_best
from leastereo_tpu.utils.torch_convert import import_torch_state_dict
from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
from leastereo_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_model import _perturbed_state_dict

H, W, MAXDISP, B = 48, 96, 48, 2
# Train-mode BN renormalises each layer's rounding with batch statistics
# through twelve cells: JAX eager against JAX jit differs by 0.0108 px max,
# 1.1e-3 px mean on these inputs.
TOL_TRAIN_MAX_PX = 0.05
TOL_TRAIN_MEAN_PX = 5e-3
# Running mean and var after one step, relative, with the tensor's largest
# entry as the floor for entries near 0 (the means): JAX eager against JAX
# jit differs by 6.4e-6 on this measure (9.8e-6 elementwise on the vars).
TOL_STATS = 1e-5


def train_setup():
    """Port weights (a cloned state_dict), the JAX variables holding them,
    and the numpy inputs: shared by this file and the gradient tests."""
    rng = np.random.RandomState(0)
    left = rng.randn(B, H, W, 3).astype(np.float32)
    right = (2.0 * rng.randn(B, H, W, 3)).astype(np.float32)
    port = best_sceneflow_model(LEAStereoConfig(maxdisp=MAXDISP, compute_dtype="float32"), device="cpu")
    # state_dict() aliases the module's tensors: clone, or a train-mode
    # forward of a model that loaded it would move its BN statistics.
    sd = {k: v.clone() for k, v in _perturbed_state_dict(port, rng).items()}
    probe = copy.deepcopy(port).train()
    with torch.no_grad():
        lt, rt = torch.from_numpy(left).permute(0, 3, 1, 2), torch.from_numpy(right).permute(0, 3, 1, 2)
        vol = probe.matching(probe.feature(lt), probe.feature(rt), MAXDISP // 3)
        sd["matching.last_3.conv.weight"].mul_(3.0 / probe.matching.last_3(vol).std())
    jax_model = jax_best(JaxConfig(maxdisp=MAXDISP, compute_dtype="float32"))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, import_torch_state_dict(shapes, sd))
    return dict(sd=sd, variables=variables, left=left, right=right, jax_model=jax_model)


def port_model(sd, **cfg):
    model = best_sceneflow_model(LEAStereoConfig(maxdisp=MAXDISP, compute_dtype="float32", **cfg), device="cpu")
    model.load_state_dict({k: v.clone() for k, v in sd.items()})
    return model


@pytest.fixture(scope="module")
def setup():
    return train_setup()


@pytest.fixture(scope="module")
def jax_train_forward(setup):
    apply = jax.jit(functools.partial(setup["jax_model"].apply, train=True, mutable=["batch_stats"]))
    disp, updates = apply(setup["variables"], setup["left"], setup["right"])
    return np.asarray(disp), state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, updates["batch_stats"])})


def test_train_forward_matches_jax(setup, jax_train_forward):
    """C1: the feature net runs per view in training, as in JAX; the port's
    joint batch pooled both views' BN statistics (35.75 px apart)."""
    ref, _ = jax_train_forward
    model = port_model(setup["sd"]).train()
    with torch.no_grad():
        got = model(torch.from_numpy(setup["left"]), torch.from_numpy(setup["right"])).numpy()
    assert got.shape == ref.shape == (B, H, W) and np.isfinite(got).all()
    assert ref.std() > 1.0
    diff = np.abs(got - ref)
    print(f"train-mode disparity against JAX: max {diff.max():.4g} px, mean {diff.mean():.4g} px")
    assert diff.max() <= TOL_TRAIN_MAX_PX and diff.mean() <= TOL_TRAIN_MEAN_PX, (diff.max(), diff.mean())


def test_train_bn_stats_match_jax(setup, jax_train_forward):
    """C1 and C2: after one train-mode forward every running mean and var
    equals JAX's ``batch_stats`` (biased variance; feature BNs updated once
    per view)."""
    _, want = jax_train_forward
    model = port_model(setup["sd"]).train()
    with torch.no_grad():
        model(torch.from_numpy(setup["left"]), torch.from_numpy(setup["right"]))
    got = model.state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * sum(k.endswith("running_var") for k in got)
    for k in names:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=TOL_STATS, atol=TOL_STATS * np.abs(w).max(), err_msg=k)
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == (2 if k.startswith("feature.") else 1), k


@pytest.mark.parametrize("ndim", [2, 3])
def test_convbr_train_bn_matches_flax(ndim):
    """C2: train-mode BN normalises with the biased batch variance and moves
    the running variance towards it, as flax's ``nn.BatchNorm``; at this
    batch of 24 (2-D) or 48 (3-D) values per channel the unbiased update is
    4% or 2% off."""
    import flax.linen as fnn

    from leastereo_tpu_torch.ops.convbr import ConvBR

    rng = np.random.RandomState(1)
    c = 4
    shape = (2, 4, 3, c) if ndim == 2 else (2, 2, 4, 3, c)
    x = (1.5 + 2.0 * rng.randn(*shape)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    variables = bn.init(jax.random.PRNGKey(0), x)
    scale, bias = (1 + 0.2 * rng.randn(c)).astype(np.float32), (0.1 * rng.randn(c)).astype(np.float32)
    mean0, var0 = (0.1 * rng.randn(c)).astype(np.float32), np.exp(0.3 * rng.randn(c)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    ref, upd = bn.apply(variables, x, mutable=["batch_stats"])

    conv = ConvBR(c, c, 1, ndim=ndim, relu=False).train()
    with torch.no_grad():
        conv.conv.weight.copy_(torch.eye(c).view(c, c, *([1] * ndim)))
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean0), ("running_var", var0)):
            getattr(conv.bn, name).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).movedim(-1, 1)
    got = conv(xt).movedim(1, -1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(conv.bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(conv.bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-6)
    assert int(conv.bn.num_batches_tracked) == 1


def test_train_head_is_the_band_wrapper(setup, monkeypatch):
    """In training the model's head is the band kernel's autograd wrapper
    (the kernel on a CUDA cost) and never the plain soft-argmin itself."""
    import leastereo_tpu_torch.models.leastereo as lst

    def no_plain(*args, **kwargs):
        raise AssertionError("the model ran the plain soft_argmin")

    calls, band = [], lst.soft_argmin_fused

    def spy(cost, maxdisp):
        calls.append(tuple(cost.shape))
        return band(cost, maxdisp)

    monkeypatch.setattr(lst, "soft_argmin", no_plain)
    monkeypatch.setattr(lst, "soft_argmin_fused", spy)
    model = port_model(setup["sd"]).train()
    with torch.no_grad():
        model(torch.from_numpy(setup["left"]), torch.from_numpy(setup["right"]))
    assert calls == [(B, MAXDISP // 3, H // 3, W // 3)]


def test_band_wrapper_saves_the_cost_as_given():
    """The wrapper keeps the bf16 cost for its backward, not an fp32 copy,
    and its gradient is the plain soft-argmin's."""
    from leastereo_tpu_torch.ops.fused_softargmin import soft_argmin_fused
    from leastereo_tpu_torch.ops.softargmin import soft_argmin

    rng = np.random.RandomState(3)
    cost = torch.from_numpy(rng.randn(2, 8, 6, 10).astype(np.float32)).to(torch.bfloat16).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.dtype) or t, lambda t: t):
        out = soft_argmin_fused(cost, 24)
    assert saved == [torch.bfloat16] and out.dtype == torch.float32
    g = torch.from_numpy(rng.randn(2, 18, 30).astype(np.float32))
    (got,) = torch.autograd.grad(out, cost, g)
    plain = cost.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(soft_argmin(plain, 24), plain, g)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# --- losses and metrics ----------------------------------------------------

def _maps(seed=0, shape=(2, 16, 24)):
    rng = np.random.RandomState(seed)
    target = rng.uniform(0.5, 40.0, shape).astype(np.float32)
    target[:, ::5, ::3] = 0.0  # occlusions
    target[:, 2::7, 1::4] = 60.0  # out of range at maxdisp 48
    pred = (target + rng.randn(*shape) * rng.choice([0.3, 4.0], shape)).astype(np.float32)
    return pred, target


LOSS_FNS = ["masked_smooth_l1", "gradient_aware_loss", "edge_aware_smoothness_loss",
            "epe", "three_px_error", "bad_pixel_frac"]


@pytest.mark.parametrize("name", LOSS_FNS)
def test_loss_or_metric_matches_jax(name):
    import leastereo_tpu.train as jtrain

    import leastereo_tpu_torch.train as ttrain

    pred, target = _maps()
    extra = (2.0,) if name == "bad_pixel_frac" else ()
    want = float(getattr(jtrain, name)(jnp.asarray(pred), jnp.asarray(target), 48, *extra))
    p = torch.from_numpy(pred).requires_grad_(name.endswith("loss") or name == "masked_smooth_l1")
    got = getattr(ttrain, name)(p, torch.from_numpy(target), 48, *extra)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    if p.requires_grad:  # the gradient the train step takes
        g_want = jax.grad(lambda q: getattr(jtrain, name)(q, jnp.asarray(target), 48))(jnp.asarray(pred))
        (g_got,) = torch.autograd.grad(got, p)
        # fp32 Sobel convolutions sum in other orders: 1e-5 of the largest entry.
        np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-5, atol=1e-5 * np.abs(g_want).max())


def test_validity_and_sobel_match_jax():
    from leastereo_tpu.train import losses as jl

    from leastereo_tpu_torch.train import losses as tl

    pred, target = _maps(1)
    assert np.array_equal(tl.validity_mask(torch.from_numpy(target), 48).numpy(),
                          np.asarray(jl.validity_mask(jnp.asarray(target), 48)))
    for got, want in zip(tl.sobel_gradients(torch.from_numpy(pred)), jl.sobel_gradients(jnp.asarray(pred))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    d = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_allclose(tl.smooth_l1(torch.from_numpy(d)).numpy(), np.asarray(jl.smooth_l1(jnp.asarray(d))))


# --- LR schedules and optimizers --------------------------------------------

SCHEDULES = [
    dict(mode="cos"),
    dict(mode="cos", warmup_epochs=2, min_lr=2e-4),
    dict(mode="poly"),
    dict(mode="poly", warmup_epochs=1),
    dict(mode="step", lr_step=2),
    dict(mode="step", lr_step=1, min_lr=5e-5, warmup_epochs=1),
    dict(mode="multistep", milestones=(1, 3, 3)),
    dict(mode="multistep", milestones=(2,), gamma=0.1, warmup_epochs=1, min_lr=1e-4),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_lr_schedule_matches_jax(kw):
    from leastereo_tpu.train import make_lr_schedule as jax_schedule

    from leastereo_tpu_torch.train import make_lr_schedule

    kw = dict(kw)
    mode = kw.pop("mode")
    epochs, spe = 5, 3
    got = make_lr_schedule(mode, 1e-3, epochs, spe, **kw)
    want = jax_schedule(mode, 1e-3, epochs, spe, **kw)
    ts = range(epochs * spe + 2)
    np.testing.assert_allclose([got(t) for t in ts], [float(want(t)) for t in ts], rtol=2e-6, atol=1e-12)
    if kw.get("warmup_epochs"):
        assert got(0) == 0.0


@pytest.mark.parametrize("solver,wd", [("adam", 0.0), ("adam", 1e-2), ("sgd", 0.0), ("sgd", 1e-2)])
def test_optimizer_matches_optax(solver, wd):
    """Three updates on a fixed gradient tree, at a different lr each."""
    from leastereo_tpu.train import make_optimizer as jax_optimizer

    from leastereo_tpu_torch.train import make_optimizer

    rng = np.random.RandomState(2)
    init = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()} for _ in range(3)]
    lrs = [1e-2, 3e-3, 5e-2]
    tx = jax_optimizer(solver, lambda t: jnp.asarray(lrs)[t], momentum=0.9, weight_decay=wd)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_optimizer(tp.values(), solver, lrs[0], momentum=0.9, weight_decay=wd)
    for lr, g in zip(lrs, grads):
        for group in opt.param_groups:
            group["lr"] = lr
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in init:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(params[k]), rtol=1e-5, atol=1e-7)


# --- freezing ---------------------------------------------------------------

@pytest.mark.parametrize("freeze_feature,freeze_matching", [(1, 0), (0, 2), (0, 4), (1, 8), (0, 12)])
def test_frozen_names_match_jax(setup, freeze_feature, freeze_matching):
    from leastereo_tpu.cli.train import freeze_labels

    from leastereo_tpu_torch.cli.train import freeze_params

    params = setup["variables"]["params"]
    labels = freeze_labels(params, bool(freeze_feature), freeze_matching)
    marks = jax.tree_util.tree_map(lambda lbl, p: np.full(p.shape, lbl == "frozen", np.float32), labels, params)
    want = {k for k, v in state_dict_from_jax({"params": marks}).items()
            if not k.endswith("num_batches_tracked") and bool(v.all())}
    model = port_model(setup["sd"])
    got = freeze_params(model, bool(freeze_feature), freeze_matching)
    assert set(got) == want and len(got) == len(want)
    assert {n for n, p in model.named_parameters() if not p.requires_grad} == want
    assert ("matching.conv1.conv.weight" in want) == (freeze_matching >= 4)
    assert ("matching.conv2.conv.weight" in want) == (freeze_matching >= 8)


# --- data pipeline ------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from test_data import _make_sceneflow_tree

    root = tmp_path_factory.mktemp("pipe")
    rels = _make_sceneflow_tree(root, scenes=("TRAIN/A/0001", "TRAIN/B/0001"), names=("0001", "0002", "0003"))
    (root / "train.list").write_text("".join(r + "\n" for r in rels))
    return root


@pytest.mark.parametrize("shuffle,drop_last,workers", [(True, True, 2), (True, False, 0), (False, False, 2)])
def test_batch_iterator_matches_jax(tree, shuffle, drop_last, workers):
    from leastereo_tpu.data import StereoListDataset as JaxDataset
    from leastereo_tpu.data.pipeline import batch_iterator as jax_batches

    from leastereo_tpu_torch.data import StereoListDataset, batch_iterator, prefetch_to_device

    kw = dict(dataset="sceneflow", list_file=str(tree / "train.list"), root=str(tree), crop_size=(12, 24),
              training=True, shift=2, seed=5)
    port_ds, jax_ds = StereoListDataset(**kw), JaxDataset(**kw)
    for epoch in (0, 1):
        it = dict(shuffle=shuffle, epoch=epoch, seed=3, drop_last=drop_last, num_workers=workers)
        got = list(batch_iterator(port_ds, 4, **it))
        want = list(jax_batches(jax_ds, 4, **it))
        assert len(got) == len(want) == (1 if drop_last else 2)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert np.array_equal(g[k], w[k]), k
        on_device = list(prefetch_to_device(iter(got), "cpu"))
        for g, t in zip(got, on_device):
            for k in g:
                assert t[k].dtype == torch.float32 and np.array_equal(t[k].numpy(), g[k])
    with pytest.raises(ValueError, match="one process"):
        next(batch_iterator(port_ds, 4, process_count=2))


def test_make_loader_steps(tree):
    from leastereo_tpu_torch.data import StereoListDataset, make_loader

    ds = StereoListDataset("sceneflow", str(tree / "train.list"), root=str(tree), crop_size=(12, 24))
    loader = make_loader(ds, 4, device="cpu", num_workers=0)
    assert loader.steps_per_epoch == 1 and len(list(loader(0))) == 1
    loader = make_loader(ds, 4, device="cpu", num_workers=0, drop_last=False, shuffle=False)
    assert loader.steps_per_epoch == 2 and [b["left"].shape[0] for b in loader(0)] == [4, 2]


# --- experiment directories, early stopping, checkpoints ------------------------

def test_early_stopping_matches_jax():
    from leastereo_tpu.utils.experiment import EarlyStopping as JaxEarlyStopping

    from leastereo_tpu_torch.utils.experiment import EarlyStopping

    metrics = [0.9, 0.8, 0.8005, 0.85, 0.7, 0.7, 0.71, 0.72, 0.73, 0.69]
    runs = []
    for cls in (EarlyStopping, JaxEarlyStopping):
        saves = []
        es = cls(patience=3, delta=0.001, period=4, save_fn=lambda kind, epoch: saves.append((kind, epoch)))
        stops = [es(m, e + 1) for e, m in enumerate(metrics)]
        runs.append((stops, saves, es.best, es.best_epoch))
    assert runs[0] == runs[1]
    assert True in runs[0][0]


def test_experiment_saver_matches_jax(tmp_path):
    import argparse

    from leastereo_tpu.utils.experiment import ExperimentSaver as JaxSaver

    from leastereo_tpu_torch.utils.experiment import ExperimentSaver

    args = argparse.Namespace(lr=1e-3, milestones=[30, 50], name="x", min_lr=None, dev=torch.device("cpu"))
    for cls, root in ((ExperimentSaver, tmp_path / "port"), (JaxSaver, tmp_path / "jax")):
        saver = cls(str(root), "kitti15", "train", "exp")
        saver.save_parameters(args)
        assert pathlib.Path(saver.logs_dir).is_dir() and pathlib.Path(saver.checkpoint_dir).is_dir()
        with pytest.raises(FileExistsError):
            cls(str(root), "kitti15", "train", "exp")
        cls(str(root), "kitti15", "train", "exp", resume=True)
    read = lambda root: json.loads((root / "kitti15-train" / "exp" / "parameters.json").read_text())
    assert read(tmp_path / "port") == read(tmp_path / "jax")


def test_checkpoint_save_latest_and_tolerant_load(setup, tmp_path):
    from leastereo_tpu_torch.utils.checkpoint import latest_checkpoint, load_state_dict_file, save_checkpoint

    model = port_model(setup["sd"])
    assert latest_checkpoint(str(tmp_path / "none")) is None
    for epoch in (2, 10, 9):
        path = save_checkpoint(str(tmp_path / "best"), epoch, model)
    assert path == str(tmp_path / "best" / "9.pth")
    assert latest_checkpoint(str(tmp_path / "best")) == str(tmp_path / "best" / "10.pth")
    obj = torch.load(path, weights_only=True)
    assert obj["epoch"] == 9 and obj["state_dict"].keys() == model.state_dict().keys()

    other = best_sceneflow_model(LEAStereoConfig(maxdisp=MAXDISP, compute_dtype="float32"), device="cpu", seed=3)
    assert load_state_dict_file(path, other) == []
    for k, v in other.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k

    # A file with one tensor of another shape and one missing: strict raises,
    # tolerant adopts the rest and keeps the model's value for those two.
    sd = {k: v.clone() + 1 for k, v in model.state_dict().items() if k != "matching.stem1.bn.bias"}
    sd["feature.stem0.conv.weight"] = torch.zeros(3, 3, 3, 3)
    torch.save({"state_dict": sd, "epoch": 1}, tmp_path / "partial.pth")
    with pytest.raises(ValueError, match="feature.stem0.conv.weight"):
        load_state_dict_file(str(tmp_path / "partial.pth"), other)
    before = {k: v.clone() for k, v in other.state_dict().items()}
    kept = load_state_dict_file(str(tmp_path / "partial.pth"), other, tolerant=True)
    assert sorted(kept) == ["feature.stem0.conv.weight", "matching.stem1.bn.bias"]
    for k, v in other.state_dict().items():
        assert torch.equal(v, before[k] if k in kept else sd[k]), k


@pytest.mark.parametrize("has_tensorboardx", [True, False])
def test_metric_logger(tmp_path, monkeypatch, capsys, has_tensorboardx):
    """stdout and ``metrics.jsonl``; ``--tensorboard`` writes event files
    through tensorboardX, or warns once and goes on without it."""
    from leastereo_tpu_torch.cli.common import MetricLogger

    if not has_tensorboardx:
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
    else:
        pytest.importorskip("tensorboardX")
    log = MetricLogger(str(tmp_path / "logs"), tensorboard=True)
    log.log(1, epoch=0, loss=np.float32(2.5))
    log.log(11, epoch=0, val_epe=1.25)
    log.close()
    out = capsys.readouterr().out
    assert ("tensorboardX not available" in out) != has_tensorboardx
    assert "step=1 epoch=0 loss=2.5" in out
    lines = [json.loads(x) for x in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert lines == [{"step": 1, "epoch": 0.0, "loss": 2.5}, {"step": 11, "epoch": 0.0, "val_epe": 1.25}]
    assert any(p.name.startswith("events.") for p in (tmp_path / "logs").iterdir()) == has_tensorboardx
