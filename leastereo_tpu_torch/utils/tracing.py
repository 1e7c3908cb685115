"""Profiling and tracing (port of ``leastereo_tpu/utils/tracing.py``).

``torch.profiler`` traces in place of ``jax.profiler``: a Chrome trace
(``chrome://tracing``, Perfetto) of the host's operators and, when a card is
in use, its kernels.

Spans: the program marks its layer boundaries with ``with span("frame"):``.
Off, the default, ``span`` checks one flag and returns a shared
``nullcontext``. On (``enable()``, or inside ``trace``), each span is a
``torch.profiler.record_function`` range named ``leastereo.<name>``, so a
running profiler holds it beside the kernels on one clock, and a record kept
in memory: its host start and end (``time.perf_counter_ns``), its parent
and the outermost span open on its thread (the root, shared by the spans of
one frame or step). ``totals()`` sums the records by name; ``reset()``
drops them. A span does nothing while ``torch.compile`` or
``torch.export`` traces, so an exported graph is the same either way.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "span", "compiler_tracing", "enable", "disable", "reset", "records", "totals", "SpanRecord", "PREFIX"]

PREFIX = "leastereo."  # of every span's range in a profiler trace

_OFF = contextlib.nullcontext()
_on = False
_records: list[SpanRecord] = []
_ids = itertools.count()


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack: list[_Span] = []


_open = _OpenSpans()  # each thread's open spans, innermost last


class SpanRecord(NamedTuple):
    """One closed span: ids are unique in the process; ``parent`` is
    ``None`` for a root, whose ``root`` is its own id. Times in
    ``time.perf_counter_ns``; ``self_ns`` is the duration less that of the
    spans opened inside it on its thread."""

    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int
    self_ns: int


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "children_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open.stack
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent, self.root = (outer.id, outer.root) if outer else (None, self.id)
        self.children_ns = 0
        self.range = record_function(PREFIX + self.name)
        self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        stack = _open.stack
        stack.pop()
        duration = end - self.start
        if stack:
            stack[-1].children_ns += duration
        _records.append(SpanRecord(self.name, self.id, self.parent, self.root, threading.get_ident(),
                                   self.start, end, duration - self.children_ns))
        return False


def compiler_tracing() -> bool:
    """Whether ``torch.compile`` or ``torch.export`` is tracing the caller."""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def span(name: str):
    """A context manager marking one layer boundary named ``name`` (module
    docstring): the shared ``nullcontext`` while the recorder is off or a
    compiler traces."""
    if not _on or compiler_tracing():
        return _OFF
    return _Span(name)


def enable() -> None:
    """Turn the recorder on: spans opened from now on are recorded."""
    global _on
    _on = True


def disable() -> None:
    """Turn the recorder off; spans already open still close their records."""
    global _on
    _on = False


def reset() -> None:
    """Drop every record kept so far."""
    _records.clear()


def records() -> list[SpanRecord]:
    """The records of the spans closed since the last ``reset``, in the
    order they closed."""
    return list(_records)


def totals() -> dict[str, dict]:
    """For each span name: ``calls``, ``host_ms`` (the durations summed) and
    ``self_host_ms`` (the same less the spans nested in them)."""
    out: dict[str, dict] = {}
    for r in list(_records):
        t = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0, "self_host_ms": 0.0})
        t["calls"] += 1
        t["host_ms"] += 1e-6 * (r.end_ns - r.start_ns)
        t["self_host_ms"] += 1e-6 * r.self_ns
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace('/tmp/trace') as prof: step()``. Writes
    ``<logdir>/trace.json`` with the program's spans as ranges named
    ``leastereo.*`` (the recorder is on inside); where a card is present it
    holds the device's kernels too, synchronised before the trace ends.
    Yields the ``torch.profiler.profile`` for ``key_averages()``."""
    global _on
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    was_on, _on = _on, True
    try:
        with profile(activities=activities) as prof:
            try:
                yield prof
            finally:
                if cuda:
                    torch.cuda.synchronize()
    finally:
        _on = was_on
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
