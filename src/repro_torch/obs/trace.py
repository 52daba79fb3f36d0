"""Span tracing with Chrome/Perfetto ``trace_event`` JSON export.

Usage::

    with start_tracing() as collector:
        simulate(trace, method)
    collector.write_chrome_trace("run.json")     # open in ui.perfetto.dev

Hot paths are instrumented with ``with span("engine/sizing_wave",
n=len(wave)): ...``. When no collector is installed (the default),
:func:`span` returns a shared null context manager after a single
module-global ``None`` check — no clock reads, no allocation — so the
disabled cost on the 100k-task replay is ~zero.

Span *counts* are deterministic: spans sit at wave/dispatch granularity,
which is a pure function of (trace, config, seed). ``BENCH_obs.json``
gates them at zero growth. Span *durations* are wall-clock and excluded
from every gate.

Side-effect-free by construction: no rng use, no event reordering, no
feedback into sizing arithmetic — bitwise invariants hold with tracing
on. Stdlib only.
"""
from __future__ import annotations

import collections
import contextlib
import json
import time

__all__ = ["TraceCollector", "span", "start_tracing", "stop_tracing",
           "tracing", "tracing_active"]


class TraceCollector:
    """Accumulates completed spans and per-name counts.

    ``spans`` holds ``(name, start_ns, dur_ns, args)`` tuples in
    completion order; ``span_counts`` is the deterministic per-name
    tally used by the bench gates."""

    def __init__(self):
        self.spans: list[tuple[str, int, int, dict]] = []
        self.span_counts: collections.Counter = collections.Counter()
        self._t0_ns = time.perf_counter_ns()

    def total_spans(self) -> int:
        return sum(self.span_counts.values())

    def to_chrome_trace(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object (complete events)."""
        t0 = self._t0_ns
        events = [{
            "name": name,
            "cat": "repro",
            "ph": "X",
            "pid": 1,
            "tid": 1,
            "ts": (start - t0) / 1000.0,
            "dur": dur / 1000.0,
            "args": args,
        } for name, start, dur, args in self.spans]
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def write_chrome_trace(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)


_COLLECTOR: TraceCollector | None = None


class _Span:
    __slots__ = ("name", "args", "start_ns")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        col = _COLLECTOR
        if col is not None:
            dur = time.perf_counter_ns() - self.start_ns
            col.spans.append((self.name, self.start_ns, dur, self.args))
            col.span_counts[self.name] += 1
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, **args):
    """Context manager timing one named region. Near-free when tracing
    is off (one global ``None`` check, shared null object)."""
    if _COLLECTOR is None:
        return _NULL_SPAN
    return _Span(name, args)


def tracing_active() -> bool:
    return _COLLECTOR is not None


def start_tracing() -> TraceCollector:
    """Install (and return) a fresh collector as the active one."""
    global _COLLECTOR
    _COLLECTOR = TraceCollector()
    return _COLLECTOR


def stop_tracing() -> TraceCollector | None:
    """Deactivate tracing; returns the collector that was active."""
    global _COLLECTOR
    col = _COLLECTOR
    _COLLECTOR = None
    return col


@contextlib.contextmanager
def tracing():
    """``with tracing() as collector: ...`` — scoped start/stop. Restores
    the previously active collector on exit, so nesting is safe."""
    global _COLLECTOR
    prev = _COLLECTOR
    col = start_tracing()
    try:
        yield col
    finally:
        _COLLECTOR = prev
