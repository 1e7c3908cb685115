"""The harness on the CPU: ``BENCHMARK.json`` against the contract's rules,
every cell resolving to its files, tiny runs of each driver through
``harness.measure`` with the plain heads, and the faults the check must
catch. The tests that need the card are marked ``cuda`` and decide inside
the test."""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import Cell, load_cell, measure
from benchmark.reference.flops import head_least_s

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for group, allowed in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) <= allowed, (group, e)
            assert NAME.match(e["name"]), e["name"]
            for text in (e.get("why"), e.get("layer"), e.get("source")):
                assert text is None or (1 <= len(text) <= 200 and "\n" not in text and "\t" not in text)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = load_cell(ROOT, cell)
    assert c.cfg["name"] == c.workload["config"]
    assert c.driver().__name__ in ("Stream", "Train", "Files")
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(c.reader(m["name"]))
    assert c.traffic["rate_metric"] in reported


def test_configs_are_listed_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for cfg in BENCH["configs"]:
        assert cfg["name"] in used
        assert (ROOT / cfg["file"]).is_file() and cfg["file"].startswith("benchmark/")
        assert json.loads((ROOT / cfg["file"]).read_text())["reduced"] == cfg["reduced"]


def test_per_layer_moves_a_metric_each_of_its_cells_reports():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert cell in CELLS
            assert m["moves"] in {e["name"] for e in Cell(BENCH, cell).end_to_end}


def test_head_least_time_at_kitti_volume():
    # (1, 32, 64, 128, 416) bf16 read once, bf16 last_3 weights, a 384x1248 fp32 map: bound by bytes
    assert head_least_s(1, 32, 64, 128, 416, 2, 2) * 1e3 == pytest.approx(0.0657, abs=5e-5)


def tiny(cell: str) -> Cell:
    """The cell at a CPU size: maxdisp 48, 48x96 frames, float32, small banks."""
    c = load_cell(ROOT, cell)
    c.cfg = dict(c.cfg, maxdisp=48, compute_dtype="float32")
    c.cfg["init"] = dict(c.cfg["init"], calibration_frame=[48, 96])
    t = c.traffic
    for key, value in (("frame", [48, 96]), ("crop", [48, 96]), ("bank", 4), ("batch", 2)):
        if key in t:
            t[key] = value
    if t["driver"] == "files":
        t["frame"] = [45, 90]
    if t["driver"] == "train":
        t["window_checked_step"] = [1, 3]
    return c


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell):
    result = measure(tiny(cell), 2**31 + 11, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"], result
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in load_cell(ROOT, cell).end_to_end}
    assert list(result)[-1] == "checks"


def _stale(fwd):
    """Each answer is the frame before's (a stale output buffer)."""
    last = []

    def stale(*args):
        last.append(fwd(*args))
        return last[-2] if len(last) > 1 else last[-1]

    return stale


@pytest.mark.parametrize("cell", ["kitti15_stream", "middlebury_stream", "kitti15_predict_files"])
def test_altered_answer_is_not_correct(cell, monkeypatch):
    import leastereo_tpu_torch.cli.predict as predict

    monkeypatch.setattr(predict, "make_forward", lambda model, _mf=predict.make_forward: _stale(_mf(model)))
    result = measure(tiny(cell), 5, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], result


def _freeze_parameters(monkeypatch, after: int = 0):
    """From the optimizer's step ``after`` on, Adam's moments move and the
    parameters come back unchanged."""
    import leastereo_tpu_torch.train.step as step

    real = step.make_optimizer

    def frozen(*args, **kwargs):
        opt = real(*args, **kwargs)
        update, calls = opt.step, []

        def step_unchanged(closure=None):
            params = [p for g in opt.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in params]
            update()
            calls.append(1)
            if len(calls) > after:
                with torch.no_grad():
                    for p, s in zip(params, saved):
                        p.copy_(s)

        opt.step = step_unchanged
        return opt

    monkeypatch.setattr(step, "make_optimizer", frozen)


def test_unchanged_state_is_not_correct(monkeypatch):
    _freeze_parameters(monkeypatch)
    result = measure(tiny("kitti15_finetune"), 6, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], result


def test_state_unchanged_in_the_window_alone_is_not_correct(monkeypatch):
    """The checked steps of the set-up are sound; from the window on the
    step leaves the parameters as they were: the watched step catches it."""
    cell = tiny("kitti15_finetune")
    _freeze_parameters(monkeypatch, after=cell.traffic["checked_steps"])
    result = measure(cell, 8, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], result
    checks = result["checks"]
    assert checks["change_median_gap"]["value"] <= checks["change_median_gap"]["limit"]
    assert checks["win_change_median_gap"]["value"] > checks["win_change_median_gap"]["limit"]


def test_unchanged_running_statistics_are_not_correct(monkeypatch):
    """Train-mode BN normalises by the batch's statistics but leaves the
    running ones as they were (momentum 0)."""
    import benchmark.drivers.train as train

    def stats_frozen(*args, _build=train.build_model, **kwargs):
        model = _build(*args, **kwargs)
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.momentum = 0.0
        return model

    monkeypatch.setattr(train, "build_model", stats_frozen)
    result = measure(tiny("kitti15_finetune"), 9, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], result
    assert result["checks"]["stats_median_gap"]["value"] == pytest.approx(1.0, abs=0.02)


def test_half_batch_is_not_correct(monkeypatch):
    from benchmark.drivers.train import Train

    full = Train.batch
    monkeypatch.setattr(Train, "batch", lambda self, j: {k: v[: len(v) // 2] for k, v in full(self, j).items()})
    monkeypatch.setattr(Train, "reference", lambda self, precision="float32", steps=None: _full_reference(self, precision, steps, full))
    result = measure(tiny("kitti15_finetune"), 7, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], result


def _full_reference(drv, precision, steps, full):
    from benchmark.reference.train import reference_steps

    batches = [tuple(torch.from_numpy(full(drv, j)[k]) for k in ("left", "right", "disparity"))
               for j in range(drv.traffic["checked_steps"] if steps is None else steps)]
    return reference_steps(drv.cfg, drv.state, batches, drv.traffic["lr"], drv.device, precision)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_on_the_card(cell):
    """At the cell's own size: the float8 reference in the program's place
    reads over a limit on three seeds, the program under every limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", cell, "--seeds", "101", "102", "103",
                          "--steps", "3", "--precisions", "fp8"], cwd=ROOT, capture_output=True, text=True, check=True)
    limits = load_cell(ROOT, cell).limits
    for line in out.stdout.strip().splitlines()[1:]:
        reading = json.loads(line)
        assert all(reading["program"][k] <= v for k, v in limits.items()), reading
        assert any(reading["fp8"][k] > v for k, v in limits.items() if k in reading["fp8"]), reading


def test_numbers_are_finite_floats():
    from benchmark.reference.compare import map_gaps

    gaps = map_gaps(np.full((4, 4), np.nan), np.zeros((4, 4)), np.zeros((4, 4)))
    assert gaps["disp_mean_gap_px"] == float("inf") and gaps["disp_beyond_3x_rounding_pct"] == 100.0


def test_trace_reduction():
    """Busy time is the union of device intervals; an operator's kernels are
    those whose ``External id`` is its own or a nested operator's; idle
    gaps take the innermost host range open halfway through them."""
    from benchmark.trace import OUTSIDE, WINDOW, reduce_trace

    def ev(name, cat, ts, dur, tid=1, ext=None):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": {"External id": ext}}

    events = [ev(WINDOW, "user_annotation", 0, 100), ev("leastereo::conv_soft_argmin", "cpu_op", 10, 20, ext=5),
              ev("aten::empty", "cpu_op", 12, 2, ext=6), ev("cudaLaunchKernel", "cuda_runtime", 15, 3, ext=5),
              ev("head", "kernel", 20, 30, tid=7, ext=5), ev("copy", "kernel", 40, 20, tid=7, ext=9),
              ev("aten::copy_", "cpu_op", 55, 30, ext=9)]
    out = reduce_trace(events)
    assert out["window_s"] == pytest.approx(100e-6) and out["busy_s"] == pytest.approx(40e-6)
    assert out["ops"]["leastereo::conv_soft_argmin"] == {"calls": 1, "device_s": pytest.approx(30e-6)}
    assert dict(out["idle_gaps"]) == pytest.approx({"leastereo::conv_soft_argmin": 20e-6, "aten::copy_": 40e-6})
    assert dict(reduce_trace(events[:1] + events[4:6])["idle_gaps"]) == pytest.approx({OUTSIDE: 60e-6})
    device_only = reduce_trace([e for e in events if e["cat"] == "kernel"], window_s=50e-6)
    assert device_only["busy_s"] == pytest.approx(40e-6) and device_only["window_s"] == pytest.approx(50e-6)
