"""Observability: the metrics registry, span tracing, and the quality and
risk telemetry rows (copies of the reference's stdlib-only
``repro.obs.metrics``, ``.trace``, ``.quality`` and ``.risk``)."""
from repro_torch.obs.metrics import (CounterFamily, Gauge, Histogram,
                                     MetricsRegistry, counter,
                                     default_registry, gauge, histogram,
                                     metrics_enabled, scrape,
                                     scoped_counters, set_metrics_enabled)
from repro_torch.obs.quality import (QUALITY_KIND, read_quality_rows,
                                     summarize_pools, write_quality_csv)
from repro_torch.obs.trace import (TraceCollector, span, start_tracing,
                                   stop_tracing, tracing, tracing_active)

__all__ = [
    "CounterFamily", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "default_registry", "gauge", "histogram",
    "metrics_enabled", "scrape", "scoped_counters", "set_metrics_enabled",
    "QUALITY_KIND", "read_quality_rows", "summarize_pools",
    "write_quality_csv",
    "TraceCollector", "span", "start_tracing", "stop_tracing", "tracing",
    "tracing_active",
]
