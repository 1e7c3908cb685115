"""The port's span recorder (``leastereo_tpu_torch/utils/tracing.py``) on the
CPU: off, a span is one shared object that records nothing and emits no
profiler range; on, records nest per thread with their parent, root and
self time, and each span is a ``leastereo.*`` range inside its parent's in
a profiler trace; the frame, train-step, load and save paths emit their
span trees; and ``torch.export`` gives the same graph either way."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from leastereo_tpu_torch import LEAStereoConfig
from leastereo_tpu_torch.cli import predict
from leastereo_tpu_torch.data import StereoListDataset
from leastereo_tpu_torch.models.genotypes import BEST_SCENEFLOW
from leastereo_tpu_torch.models.leastereo import LEAStereo
from leastereo_tpu_torch.train.step import make_optimizer, train_step
from leastereo_tpu_torch.utils import tracing
from leastereo_tpu_torch.utils.tracing import span

# BEST_SCENEFLOW at narrow widths: H and W multiples of its size_multiple, 24.
TINY = LEAStereoConfig(maxdisp=24, fea_filter_multiplier=2, mat_filter_multiplier=2, compute_dtype="float32")
H, W = 24, 48


@pytest.fixture(autouse=True)
def recorder_off_after():
    """Every test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def tree(records) -> list:
    """The records as nested ``(name, children)`` pairs, each level in the
    order the spans opened."""
    kids = {}
    for r in sorted(records, key=lambda r: r.start_ns):
        kids.setdefault(r.parent, []).append(r)

    def build(parent):
        return [(r.name, build(r.id)) for r in kids.get(parent, [])]

    return build(None)


def model(train: bool = False) -> LEAStereo:
    gen = torch.Generator().manual_seed(0)
    return LEAStereo(BEST_SCENEFLOW["feature"], BEST_SCENEFLOW["matching"], TINY, gen).train(train)


def test_off_is_one_shared_object_that_records_and_emits_nothing():
    assert span("frame") is span("forward")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("frame"):
            torch.ones(4) + 1
    assert tracing.records() == [] and tracing.totals() == {}
    assert not [e.key for e in prof.key_averages() if e.key.startswith(tracing.PREFIX)]


def test_on_nests_with_parent_root_and_self_time():
    tracing.enable()
    with span("outer"):
        time.sleep(0.002)
        with span("inner"):
            time.sleep(0.002)
            with span("leaf"):
                pass
        with span("inner"):
            pass
    with span("second"):
        pass
    by = {}
    for r in tracing.records():
        by.setdefault(r.name, []).append(r)
    (outer,), (leaf,), (second,) = by["outer"], by["leaf"], by["second"]
    assert outer.parent is None and outer.root == outer.id
    assert [r.parent for r in by["inner"]] == [outer.id, outer.id]
    assert leaf.parent == by["inner"][0].id and leaf.root == outer.id
    assert second.parent is None and second.root == second.id != outer.id
    for r in tracing.records():
        inside = sum(c.end_ns - c.start_ns for c in tracing.records() if c.parent == r.id)
        assert r.self_ns == r.end_ns - r.start_ns - inside
    assert outer.self_ns >= 2e6
    totals = tracing.totals()
    assert totals["inner"]["calls"] == 2 and totals["outer"]["calls"] == 1
    assert totals["outer"]["host_ms"] == pytest.approx(1e-6 * (outer.end_ns - outer.start_ns))
    assert totals["outer"]["self_host_ms"] == pytest.approx(1e-6 * outer.self_ns)
    tracing.disable()
    with span("after"):
        pass
    assert "after" not in tracing.totals()
    tracing.reset()
    assert tracing.records() == []


def test_each_thread_keeps_its_own_stack():
    """A span opened on a worker thread while the main thread holds one open
    is a root of its own thread, not a child of the main thread's."""
    tracing.enable()
    opened = threading.Barrier(3, timeout=10)

    def worker():
        with span("load"):
            opened.wait()
            with span("decode"):
                pass

    with span("frame"):
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        opened.wait()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    recs = tracing.records()
    frame = next(r for r in recs if r.name == "frame")
    loads = [r for r in recs if r.name == "load"]
    assert len(loads) == 2 and all(r.parent is None and r.root == r.id for r in loads)
    assert {r.thread for r in loads} | {frame.thread} == {r.thread for r in recs} and len({r.thread for r in recs}) == 3
    for d in (r for r in recs if r.name == "decode"):
        assert d.parent in {r.id for r in loads} and d.root == d.parent


def test_trace_writes_each_span_as_a_range_inside_its_parent(tmp_path):
    with tracing.trace(str(tmp_path / "tr")):
        with span("outer"):
            with span("inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert span("after") is span("other")  # trace turned the recorder off again
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    outer, inner = ranges["leastereo.outer"], ranges["leastereo.inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    mm = next(e for e in events if e.get("name") == "aten::mm")
    assert inner["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= inner["ts"] + inner["dur"]
    assert [r.name for r in tracing.records()] == ["inner", "outer"]


def _frame(tmp_path):
    fwd = predict.make_forward(model())
    left, right = np.random.default_rng(0).standard_normal((2, 1, H, W, 3)).astype(np.float32)
    tracing.enable()
    fwd(left, right)


def _step(tmp_path):
    net = model(train=True)
    rng = np.random.default_rng(0)
    batch = {"left": rng.standard_normal((2, H, W, 3), np.float32),
             "right": rng.standard_normal((2, H, W, 3), np.float32),
             "disparity": rng.uniform(1, 20, (2, H, W)).astype(np.float32)}
    opt = make_optimizer(net.parameters(), "adam", 1e-3)
    tracing.enable()
    train_step(net, opt, batch, TINY.maxdisp, 1e-3)


def _kitti_pair(root) -> StereoListDataset:
    """One 12x20 KITTI 2015 frame on disk: an 8-bit pair, 16-bit disparity."""
    rng = np.random.default_rng(0)
    for d in ("image_2", "image_3"):
        (root / d).mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)).save(root / d / "000000_10.png")
    (root / "disp_occ_0").mkdir()
    Image.fromarray(rng.integers(0, 2**15, (12, 20)).astype(np.uint16)).save(root / "disp_occ_0" / "000000_10.png")
    (root / "frames.list").write_text("image_2/000000_10.png\n")
    return StereoListDataset(dataset="kitti15", list_file=str(root / "frames.list"), root=str(root),
                             crop_size=(24, 24), training=False)


def _load(tmp_path):
    ds = _kitti_pair(tmp_path)
    tracing.enable()
    ds.load_stack(0)


def _save(tmp_path):
    disp = np.random.default_rng(0).uniform(0, 20, (12, 20)).astype(np.float32)
    tracing.enable()
    predict.save_frame(str(tmp_path), "f", disp)


def _save_all(tmp_path):
    rng = np.random.default_rng(0)
    disp, entropy, gt = rng.uniform(0, 20, (3, 12, 20)).astype(np.float32)
    tracing.enable()
    predict.save_frame(str(tmp_path), "f", disp, entropy, gt)


FORWARD = ("forward", [("feature", []), ("matching", [("stem", [])]), ("head", [])])
TRAIN_FORWARD = ("forward", [("feature", []), ("feature", []), ("matching", [("stem", [])]), ("head", [])])
DECODE = ("decode", [])
PNG, NPY = ("png", []), ("npy", [])


@pytest.mark.parametrize("run, expected", [
    (_frame, [("frame", [("h2d", []), FORWARD, ("d2h", [])])]),
    (_step, [("step", [("h2d", []), TRAIN_FORWARD, ("loss", []), ("backward", []), ("optimizer", []),
                       ("metrics", [])])]),
    (_load, [("load", [DECODE, DECODE, DECODE, ("standardize", [])])]),
    (_save, [("save", [("colorize", []), PNG, NPY])]),
    (_save_all, [("save", [PNG, NPY, ("colorize", []), PNG, NPY, ("colorize", []), PNG])]),
], ids=["frame", "train_step", "load_stack", "save_frame", "save_frame_confidence_gt"])
def test_paths_emit_their_span_trees(tmp_path, run, expected):
    run(tmp_path)
    assert tree(tracing.records()) == expected


def test_export_graph_is_the_same_with_the_recorder_on():
    net = model()
    left, right = torch.randn(2, 1, H, W, 3).unbind(0)
    off = torch.export.export(net, (left, right)).graph_module.code
    tracing.enable()
    on = torch.export.export(net, (left, right)).graph_module.code
    assert tracing.records() == []
    assert on == off and "record_function" not in on
