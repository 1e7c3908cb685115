"""``benchmark/spans.py`` on synthetic chrome-trace events and on a CPU
profiler trace of the port's own spans: each span's kernels, busy and idle
time, a backward operation on autograd's thread counted to the main
thread's ``backward``, and the table beside the recorder's host totals."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.spans import OUTSIDE_SPANS, reduce_spans, span_table
from benchmark.trace import WINDOW, reduce_trace


def ev(name, cat, ts, dur, tid=1, ext=None):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": {"External id": ext}}


# A frame (feature, then matching inside forward) and a backward whose
# operation runs on a second host thread; device intervals [70, 120],
# [150, 280] (two overlapping kernels), [700, 750] and [960, 990]. The idle
# gap [280, 700] crosses matching, forward, frame, no span and backward.
EVENTS = [
    ev(WINDOW, "user_annotation", 0, 1000),
    ev("leastereo.frame", "user_annotation", 10, 490),
    ev("leastereo.forward", "user_annotation", 20, 380),
    ev("leastereo.feature", "user_annotation", 30, 70),
    ev("aten::convolution", "cpu_op", 40, 20, ext=1),
    ev("cudaLaunchKernel", "cuda_runtime", 45, 5, ext=1),
    ev("conv", "kernel", 70, 50, tid=7, ext=1),
    ev("leastereo.matching", "user_annotation", 110, 190),
    ev("aten::mm", "cpu_op", 120, 10, ext=2),
    ev("aten::mm", "cpu_op", 140, 5, ext=3),
    ev("gemm", "kernel", 150, 100, tid=7, ext=2),
    ev("gemm", "kernel", 240, 40, tid=7, ext=3),
    ev("leastereo.backward", "user_annotation", 600, 300),
    ev("autograd::engine::evaluate_function: ConvolutionBackward0", "cpu_op", 650, 50, tid=2, ext=4),
    ev("wgrad", "kernel", 700, 50, tid=7, ext=4),
    ev("aten::add", "cpu_op", 950, 10, tid=2, ext=5),
    ev("add", "kernel", 960, 30, tid=7, ext=5),
]


def test_spans_hold_their_kernels_busy_and_idle_time():
    out = reduce_spans(EVENTS)
    expected = {  # kernels, busy, innermost idle, idle while open (us)
        "frame": (3, 180, 110, 310),
        "forward": (3, 180, 110, 200),
        "feature": (1, 50, 40, 40),
        "matching": (2, 130, 50, 50),
        "backward": (1, 50, 250, 250),
    }
    assert set(out) == set(expected) | {OUTSIDE_SPANS}
    for name, (kernels, busy, idle, under) in expected.items():
        rec = out[name]
        assert rec["calls"] == 1 and rec["kernels"] == kernels, name
        assert rec["busy_s"] == pytest.approx(busy * 1e-6), name
        assert (rec["idle_s"], rec["idle_under_s"]) == pytest.approx((idle * 1e-6, under * 1e-6)), name
    assert out["matching"]["top"] == [["gemm", pytest.approx(140e-6)]]
    assert out["backward"]["top"] == [["wgrad", pytest.approx(50e-6)]]
    assert out[OUTSIDE_SPANS] == {"idle_s": pytest.approx(180e-6)}
    total_idle = sum(r["idle_s"] for r in out.values())
    window = reduce_trace(EVENTS)
    assert total_idle == pytest.approx(window["window_s"] - window["busy_s"])
    assert reduce_spans(EVENTS[1:]) == {}


def test_the_table_divides_by_the_root_calls():
    host = {"frame": {"calls": 4, "host_ms": 40.0, "self_host_ms": 8.0},
            "h2d": {"calls": 4, "host_ms": 8.0, "self_host_ms": 8.0}}
    device = {"frame": {"calls": 2, "kernels": 10, "busy_s": 0.004, "idle_s": 0.002, "top": [["k", 0.003]]},
              OUTSIDE_SPANS: {"idle_s": 0.001}}
    table = span_table(host, device, "frame")
    assert table["frame"] == pytest.approx({"calls": 1, "host_ms": 10.0, "self_ms": 2.0, "kernels": 5,
                                            "busy_ms": 2.0, "idle_ms": 1.0, "top": [["k", 1.5]]})
    assert table["h2d"] == {"calls": 1, "host_ms": 2.0, "self_ms": 2.0}
    assert table[OUTSIDE_SPANS] == {"idle_ms": pytest.approx(0.5)}


def test_a_cpu_trace_of_the_program_spans_reduces(tmp_path):
    """The port's spans in a real (CPU) profiler trace: each range counted
    once a call, and, with no device work, the whole stretch idle, split
    between the spans and the time outside them."""
    from leastereo_tpu_torch.utils import tracing
    from leastereo_tpu_torch.utils.tracing import span

    with tracing.trace(str(tmp_path)):
        with torch.profiler.record_function(WINDOW):
            for _ in range(2):
                with span("frame"):
                    with span("forward"):
                        torch.ones(16, 16) @ torch.ones(16, 16)
    tracing.reset()
    out = reduce_spans(json.loads((tmp_path / "trace.json").read_text())["traceEvents"])
    assert {k: v["calls"] for k, v in out.items() if k != OUTSIDE_SPANS} == {"frame": 2, "forward": 2}
    assert out["frame"]["kernels"] == 0 and out["frame"]["busy_s"] == 0.0
    window = reduce_trace(json.loads((tmp_path / "trace.json").read_text())["traceEvents"])["window_s"]
    assert sum(r["idle_s"] for r in out.values()) == pytest.approx(window)
    assert 0 < out["forward"]["idle_s"] <= out["forward"]["idle_under_s"] <= out["frame"]["idle_under_s"]
