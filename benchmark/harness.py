"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

Everything of a cell is found by name from ``BENCHMARK.json``: the
configuration ``configs/<config>.json``, the traffic ``traffic/<traffic>.json``
(whose ``driver`` names a module of ``drivers/``), the limits of the check
``limits/<workload>.json`` and one reader for each per-layer metric:
``metrics/<metric>.py``, or where there is none, the reader of the name's
part before its first dot (``mfu.train`` reads with ``metrics/mfu.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

__all__ = ["Cell", "card", "load_cell", "measure", "run"]

HERE = pathlib.Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "optax", "leastereo_tpu")  # compared whole, by top-level name


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and the metrics it reports."""

    def __init__(self, bench: dict, name: str, base: pathlib.Path = HERE):
        workloads = {w["name"]: w for w in bench["workloads"]}
        if name not in workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(workloads)}")
        self.workload = workloads[name]
        self.name = name
        self.chips = self.workload["chips"]
        self.cfg = json.loads((base / "configs" / f"{self.workload['config']}.json").read_text())
        self.traffic = json.loads((base / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads((base / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.traffic['driver']}").Driver

    def reader(self, metric: str):
        path = HERE / "metrics" / f"{metric}.py"
        if not path.is_file():
            path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def load_cell(root: pathlib.Path, name: str) -> Cell:
    return Cell(json.loads((root / "BENCHMARK.json").read_text()), name)


class Readings:
    """What a per-layer metric's reader reads: span times (ms) of the
    instrumented window, its units and seconds, the reduced trace of the
    profiled stretch, and the cell driver's counts of the work
    (``flops_per_unit``, ``head_least_s``)."""

    def __init__(self, spans: dict, units: int, window_s: float, trace: dict, facts: dict):
        self.spans, self.units, self.window_s, self.trace, self.facts = spans, units, window_s, trace, facts

    def mean_ms(self, name: str) -> float | None:
        v = self.spans.get(name)
        return float(np.mean(v)) if v else None

    def idle_pct(self) -> float | None:
        t = self.trace
        return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t.get("window_s") else None


def card(count: int) -> dict:
    """The card the run used: name, count and power limit (W)."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, check=False)
    try:
        out["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def _window(drv, seconds: float) -> tuple[int, float, list[float]]:
    """Steps until ``seconds`` have passed: the count, the seconds from the
    first step's start to the last one's end, and each step's seconds."""
    drv.start_window()
    lat, start = [], time.perf_counter()
    t = start
    while not lat or t - start < seconds:
        drv.step()
        now = time.perf_counter()
        lat.append(now - t)
        t = now
    return len(lat), t - start, lat


def quarter_rates(lat: list[float], units_per_step: int) -> list[float]:
    """Units a second in each quarter of the window, a step counted in the
    quarter in which it ended: whether a run's rate drifts within it."""
    ends = np.cumsum(lat)
    quarter = ends[-1] / 4
    counts = np.bincount(np.minimum((ends / quarter).astype(int), 3), minlength=4)
    return [float(units_per_step * c / quarter) for c in counts]


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``cell`` on ``device``: the result line's fields, the
    compared numbers last. Only a card can be traced."""
    import torch

    from .program import launch_counts
    from .trace import Spans, profile

    cuda = device.type == "cuda"
    drv = cell.driver()(cell.cfg, cell.traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    setup_s = elapsed - drv.phases.outside()
    print("setup " + json.dumps({"before_driver": elapsed - sum(drv.phases.seconds.values()), **drv.phases.seconds,
                                 "setup_s": setup_s}), file=sys.stderr)

    spans = Spans()
    handles = drv.instrument(spans) if trace else []
    steps, window_s, lat = _window(drv, seconds)
    attempted, failed = steps * drv.units_per_step, drv.failed
    for h in handles:
        h.remove()
    print("window_quarters " + json.dumps(quarter_rates(lat, drv.units_per_step)), file=sys.stderr)
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        traced = profile(drv.step, cell.traffic["profiled_steps"])
        readings = Readings(spans.ms(), attempted, window_s, traced, drv.trace_facts())
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, cell.traffic["rate_metric"]: attempted / window_s}
        if "latency_p95_metric" in cell.traffic:
            e2e[cell.traffic["latency_p95_metric"]] = 1e3 * float(np.percentile(lat, 95))
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    if cuda:
        result["device"] = dict(card(cell.chips), memory_peak_bytes=torch.cuda.max_memory_allocated(device))
    if trace:
        result["device"].update(busy_s=traced.get("busy_s", 0.0), window_s=traced.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": traced.get("device_ops", []), "idle_gaps": traced.get("idle_gaps", [])}
        result["launches"] = launch_counts()

    numbers = drv.check()
    checks = {k: {"value": numbers[k], "limit": limit} for k, limit in cell.limits.items()}
    result["correct"] = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def run(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool, t0: float) -> int:
    """Run ``workload`` on the card and print its result; 2 without the
    devices it asks for, 3 if the run loaded JAX or the JAX package."""
    cell = load_cell(root, workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {workload} needs {cell.chips} CUDA device(s), found {have}; no result", file=sys.stderr)
        return 2
    result = measure(cell, seed, seconds, trace, torch.device("cuda", 0), t0)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if loaded:
        print(f"benchmark: the run loaded {loaded}; no result", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
