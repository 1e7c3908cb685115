"""Spans taken from the benchmark's own files, and the reduction of a
``torch.profiler`` trace to device busy time, idle gaps and the device
time of the kernels launched under one operator."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

__all__ = ["Spans", "profile", "reduce_trace"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "benchmark_window"
OPERATOR_NAMESPACE = "leastereo::"  # the program's custom operators
OUTSIDE = "host outside any operator (Python)"


class Spans:
    """Host-clock spans (seconds) and CUDA-event spans by name. Event pairs
    are read once the device has finished them (:meth:`ms`)."""

    def __init__(self):
        self.host: dict[str, list[float]] = collections.defaultdict(list)
        self.events: dict[str, list] = collections.defaultdict(list)
        self._open: dict[str, object] = {}

    def add_host(self, name: str, seconds: float) -> None:
        self.host[name].append(seconds)

    def start_event(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._open[name] = ev

    def end_event(self, name: str, start: str | None = None) -> None:
        """Close the span ``name``, opened under ``start`` (default ``name``)."""
        begin = self._open.pop(start or name, None)
        if begin is None:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name].append((begin, ev))

    def ms(self) -> dict[str, list[float]]:
        """Every span in milliseconds, host and device."""
        torch.cuda.synchronize()
        out = {k: [1e3 * s for s in v] for k, v in self.host.items()}
        out.update({k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()})
        return out


def profile(step, n: int) -> dict:
    """Two stretches of ``n`` calls of ``step``: one with the device's
    activity alone traced, for the busy seconds against the host clock's
    window and the operations that took most time; one with the host's
    operators too, for the operators' kernels and what the host was doing in
    each idle gap (the host's tracing slows it, so those gaps run long)."""
    import time

    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device = reduce_trace(_events(prof), window_s=window_s)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            torch.cuda.synchronize()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    host = reduce_trace(_events(prof))
    return dict(device, idle_gaps=host.get("idle_gaps", []), ops=host.get("ops", {}))


def _events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events: list[dict], top: int = 10, window_s: float | None = None) -> dict:
    """From chrome-trace events: the traced window (the ``WINDOW`` range,
    or ``window_s`` from the host's clock over a trace of the device
    alone), the seconds in which a kernel, copy or set ran on the device
    (union of intervals), the device operations that took most time, the
    idle gaps summed by what the host was doing halfway through each (the
    innermost host operation or runtime call open then), and for each host
    operator of the program's namespace the device seconds and calls of
    every kernel launched inside it (by the ``External id`` of the operator
    and of those nested in it)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next((e for e in spans if e.get("name") == WINDOW), None)
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if win is not None:
        w0, w1 = win["ts"], win["ts"] + win["dur"]
    elif window_s is not None and device:
        w0 = min(e["ts"] for e in device)
        w1 = w0 + 1e6 * window_s
    else:
        return {}
    device = [e for e in device if w0 <= e["ts"] < w1]
    merged = _merge([(e["ts"], min(e["ts"] + e["dur"], w1)) for e in device])
    busy_us = sum(b - a for a, b in merged)

    by_name = collections.Counter()
    for e in device:
        by_name[e["name"][:160]] += e["dur"]
    host = [e for e in spans if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
            and e.get("name") != WINDOW and win is not None and e.get("tid") == win.get("tid")]
    host.sort(key=lambda e: e["ts"])
    gaps = collections.Counter()
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    stack, j = [], 0  # host ranges on one thread nest: the innermost open one is the stack's top
    for a, b in zip(edges[0::2], edges[1::2]):
        mid = (a + b) / 2
        while j < len(host) and host[j]["ts"] <= mid:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= host[j]["ts"]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= mid:
            stack.pop()
        if b > a:
            gaps[(stack[-1]["name"] if stack else OUTSIDE)[:160]] += b - a

    ops = collections.defaultdict(lambda: {"device_s": 0.0, "calls": 0, "ids": set()})
    cpu_ops = [e for e in host if e.get("cat") == "cpu_op"]
    starts = [e["ts"] for e in cpu_ops]
    for e in cpu_ops:
        if not e["name"].startswith(OPERATOR_NAMESPACE):
            continue
        rec = ops[e["name"]]
        rec["calls"] += 1
        t1 = e["ts"] + e["dur"]
        inner = cpu_ops[bisect.bisect_left(starts, e["ts"]) : bisect.bisect_right(starts, t1)]
        rec["ids"].update(o.get("args", {}).get("External id") for o in inner if o["ts"] + o["dur"] <= t1)
    for rec in ops.values():
        ids = rec.pop("ids")
        rec["device_s"] = 1e-6 * sum(e["dur"] for e in device if e.get("cat") == "kernel"
                                     and e.get("args", {}).get("External id") in ids)
    return {
        "window_s": 1e-6 * (w1 - w0),
        "busy_s": 1e-6 * busy_us,
        "device_ops": [[k, 1e-6 * v] for k, v in by_name.most_common(top)],
        "idle_gaps": [[k, 1e-6 * v] for k, v in gaps.most_common(top)],
        "ops": dict(ops),
    }
