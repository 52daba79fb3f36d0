"""Observability: the metrics registry and span tracing (copies of the
reference's stdlib-only ``repro.obs.metrics`` and ``repro.obs.trace``).
Quality telemetry comes with the telemetry slice."""
from repro_torch.obs.metrics import (CounterFamily, Gauge, Histogram,
                                     MetricsRegistry, counter,
                                     default_registry, gauge, histogram,
                                     metrics_enabled, scrape,
                                     scoped_counters, set_metrics_enabled)
from repro_torch.obs.trace import (TraceCollector, span, start_tracing,
                                   stop_tracing, tracing, tracing_active)

__all__ = [
    "CounterFamily", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "default_registry", "gauge", "histogram",
    "metrics_enabled", "scrape", "scoped_counters", "set_metrics_enabled",
    "TraceCollector", "span", "start_tracing", "stop_tracing", "tracing",
    "tracing_active",
]
