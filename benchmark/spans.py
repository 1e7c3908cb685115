"""The program's own spans in a host-traced ``torch.profiler`` stretch: for
each ``leastereo.*`` range (``leastereo_tpu_torch/utils/tracing.py``
``span``), the kernels launched inside it, the device time they kept busy
and the device's idle time while the host was inside it; and the table that
puts these beside the recorder's host totals of a window.

The harness does not call this yet: ``trace.profile`` would pass its
host-traced events to :func:`reduce_spans`, and ``harness.measure`` would
turn the recorder on around the window and the profiled stretch."""

from __future__ import annotations

import bisect
import collections

from .trace import DEVICE_CATS, WINDOW, _merge

__all__ = ["PREFIX", "OUTSIDE_SPANS", "reduce_spans", "span_table"]

PREFIX = "leastereo."
OUTSIDE_SPANS = "outside every program span"
HOST_CATS = ("cpu_op", "user_annotation")


def _segments(ranges: list[dict]) -> list[tuple[float, float, list[str]]]:
    """The stretches between consecutive starts and ends of ``ranges`` (one
    thread's, which nest), each with the names of the ranges open in it,
    outermost first."""
    points = sorted({r["ts"] for r in ranges} | {r["ts"] + r["dur"] for r in ranges})
    out = []
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2
        out.append((a, b, [r["name"][len(PREFIX):] for r in ranges if r["ts"] <= mid < r["ts"] + r["dur"]]))
    return out


def reduce_spans(events: list[dict], top: int = 3) -> dict:
    """From the chrome-trace events of a stretch inside the ``WINDOW``
    range: for each span name, ``calls``; ``kernels``, the kernels launched
    by host operations inside its ranges (by ``External id``, as
    ``trace.reduce_trace`` matches an operator's kernels); ``busy_s``, the
    union of the device intervals of those kernels, copies and sets;
    ``idle_s``, the device's idle seconds in which it was the innermost span
    open on the window's thread, and ``idle_under_s`` those in which it was
    open at all (each idle gap split over the spans open in it, so that a
    gap across a frame's save, load and pad is not put down to one of
    them); ``top``, the kernels that took most device time under it. A
    range on the window's thread also owns the operations of other host
    threads inside its interval (autograd runs the backward on its own
    thread while that thread waits in ``backward()``). ``OUTSIDE_SPANS``
    holds the idle seconds in which no span was open."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next((e for e in spans if e.get("name") == WINDOW), None)
    if win is None:
        return {}
    w0, w1, main = win["ts"], win["ts"] + win["dur"], win.get("tid")
    device = [e for e in spans if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] < w1]
    by_id = collections.defaultdict(list)
    for e in device:
        by_id[e.get("args", {}).get("External id")].append(e)
    host = sorted((e for e in spans if e.get("cat") in HOST_CATS and e.get("name") != WINDOW), key=lambda e: e["ts"])
    host_starts = [e["ts"] for e in host]
    ranges = [e for e in host if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]

    out = {}
    for r in ranges:
        rec = out.setdefault(r["name"][len(PREFIX):], {"calls": 0, "ids": set(), "idle_s": 0.0, "idle_under_s": 0.0})
        rec["calls"] += 1
        t1 = r["ts"] + r["dur"]
        inside = host[bisect.bisect_left(host_starts, r["ts"]) : bisect.bisect_right(host_starts, t1)]
        rec["ids"].update(o.get("args", {}).get("External id") for o in inside
                          if o["ts"] + o["dur"] <= t1 and (o.get("tid") == r.get("tid") or r.get("tid") == main))
    for rec in out.values():
        ops = [d for i in rec.pop("ids") - {None} for d in by_id.get(i, [])]
        kernels = [d for d in ops if d.get("cat") == "kernel"]
        rec["kernels"] = len(kernels)
        rec["busy_s"] = 1e-6 * sum(b - a for a, b in _merge([(d["ts"], min(d["ts"] + d["dur"], w1)) for d in ops]))
        time_by_name = collections.Counter()
        for k in kernels:
            time_by_name[k["name"][:160]] += 1e-6 * k["dur"]
        rec["top"] = [[k, s] for k, s in time_by_name.most_common(top)]

    segments = _segments(sorted((r for r in ranges if r.get("tid") == main), key=lambda r: r["ts"]))
    merged = _merge([(e["ts"], min(e["ts"] + e["dur"], w1)) for e in device])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    outside, j = 0.0, 0
    for a, b in zip(edges[0::2], edges[1::2]):  # each idle gap, split over the segments it crosses
        covered = 0.0
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        for s0, s1, names in segments[j:]:
            if s0 >= b:
                break
            overlap = 1e-6 * (min(b, s1) - max(a, s0))
            if overlap <= 0 or not names:
                continue
            covered += overlap
            out[names[-1]]["idle_s"] += overlap
            for name in set(names):
                out[name]["idle_under_s"] += overlap
        outside += 1e-6 * max(b - a, 0) - covered
    out[OUTSIDE_SPANS] = {"idle_s": outside}
    return out


def span_table(host: dict, device: dict, host_root: str, device_root: str | None = None) -> dict:
    """Per span name, host ms a unit from the recorder's ``totals()`` over a
    window (``host``; a unit is a call of ``host_root``), and the device
    numbers of a traced stretch (``device``, from :func:`reduce_spans`) a
    unit of that stretch (a call of ``device_root``, default ``host_root``):
    calls, kernels, busy and idle ms, and the longest kernels."""
    units = host.get(host_root, {}).get("calls") or 1
    traced = device.get(device_root or host_root, {}).get("calls") or 1
    table = {}
    for name in sorted(set(host) | set(device)):
        h, d = host.get(name, {}), device.get(name, {})
        row = {}
        if h:
            row.update(calls=h["calls"] / units, host_ms=h["host_ms"] / units, self_ms=h["self_host_ms"] / units)
        if "kernels" in d:
            row.update(kernels=d["kernels"] / traced, busy_ms=1e3 * d["busy_s"] / traced)
        if d:
            row["idle_ms"] = 1e3 * d["idle_s"] / traced
        if d.get("top"):
            row["top"] = [[k, 1e3 * s / traced] for k, s in d["top"]]
        table[name] = row
    return table
