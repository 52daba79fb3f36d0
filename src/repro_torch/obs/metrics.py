"""Metrics registry: named counter / gauge / histogram families with
Prometheus-style text exposition.

Design constraints:

  * **Counters are always on.** The families absorbing the legacy
    process globals (``TRACE_COUNTS`` / ``DISPATCH_COUNTS`` /
    ``BOUNDARY_COUNTS``) feed deterministic CI regression gates and
    dozens of snapshot-before / diff-after call sites, so a
    :class:`CounterFamily` IS a ``collections.Counter`` — same bump
    cost, same duck type, zero behavioural change for existing
    consumers. Disabling the registry never silences them.
  * **Gauges and histograms are optional instruments.** ``Gauge.set``
    is cold-path (scrape time) and always works; ``Histogram.observe``
    sits on warm paths and becomes a single attribute check when the
    registry is disabled (:func:`set_metrics_enabled`), so a disabled
    registry costs ~zero on the 100k-task replay.
  * **Scoping.** :func:`scoped_counters` brackets a run: inside the
    ``with``, every family counts from zero (independent measurements
    for back-to-back simulations); on exit the pre-scope counts are
    added back, so process totals are preserved.

Stdlib only — importable from every subsystem without cycles.
"""
from __future__ import annotations

import collections
import contextlib

__all__ = ["CounterFamily", "Gauge", "Histogram", "MetricsRegistry",
           "counter", "default_registry", "gauge", "histogram",
           "metrics_enabled", "scrape", "scoped_counters",
           "set_metrics_enabled"]

# default latency-style bucket bounds (seconds), Prometheus convention
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


class CounterFamily(collections.Counter):
    """A named family of monotonically increasing counters, keyed by a
    free-form label value (``family["predict_pool"] += 1``).

    Subclasses ``collections.Counter`` so the legacy global-Counter
    consumers (``dict(family)`` snapshots, ``family[key] - before.get(
    key, 0)`` diffs) keep working unchanged."""

    def __init__(self, name: str, help: str = ""):
        super().__init__()
        self.name = name
        self.help = help

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}".rstrip(),
                 f"# TYPE {self.name} counter"]
        for key in sorted(self, key=str):
            lines.append(f'{self.name}{{kind="{key}"}} {self[key]}')
        return lines


class Gauge:
    """A named family of instantaneous values, keyed by label pairs:
    ``gauge.set(3, tenant="genomics")``. Cold-path (set at scrape or
    report time), so it ignores the enabled flag."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        self._values[tuple(sorted(labels.items()))] = float(value)

    def get(self, **labels) -> float | None:
        return self._values.get(tuple(sorted(labels.items())))

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}".rstrip(),
                 f"# TYPE {self.name} gauge"]
        for key in sorted(self._values):
            lbl = ",".join(f'{k}="{v}"' for k, v in key)
            sfx = f"{{{lbl}}}" if lbl else ""
            lines.append(f"{self.name}{sfx} {self._values[key]:g}")
        return lines


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics:
    ``_bucket{le=...}`` counts observations <= each bound, plus ``_sum``
    / ``_count``). ``observe`` is warm-path: a no-op while the owning
    registry is disabled."""

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                 registry: "MetricsRegistry | None" = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._registry = registry
        self._counts = [0] * (len(self.buckets) + 1)   # +inf tail
        self._sum = 0.0
        self._n = 0

    def observe(self, value: float) -> None:
        reg = self._registry
        if reg is not None and not reg.enabled:
            return
        value = float(value)
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                self._counts[i] += 1
                break
        else:
            self._counts[-1] += 1
        self._sum += value
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}".rstrip(),
                 f"# TYPE {self.name} histogram"]
        cum = 0
        for bound, n in zip(self.buckets, self._counts):
            cum += n
            lines.append(f'{self.name}_bucket{{le="{bound:g}"}} {cum}')
        cum += self._counts[-1]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{self.name}_sum {self._sum:g}")
        lines.append(f"{self.name}_count {self._n}")
        return lines


class MetricsRegistry:
    """Process registry of metric families, one exposition endpoint.

    ``enabled`` gates the warm-path instruments (histograms) only;
    counters always count (see module docstring) and gauges are
    cold-path. Families are get-or-create by name, so re-imports and
    repeated ``counter(...)`` calls share one instance."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._families: dict[str, object] = {}

    def _get(self, name: str, factory):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = factory()
        return fam

    def counter(self, name: str, help: str = "") -> CounterFamily:
        fam = self._get(name, lambda: CounterFamily(name, help))
        if not isinstance(fam, CounterFamily):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(fam).__name__}")
        return fam

    def gauge(self, name: str, help: str = "") -> Gauge:
        fam = self._get(name, lambda: Gauge(name, help))
        if not isinstance(fam, Gauge):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(fam).__name__}")
        return fam

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        fam = self._get(name,
                        lambda: Histogram(name, help, buckets, registry=self))
        if not isinstance(fam, Histogram):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(fam).__name__}")
        return fam

    def counters(self) -> list[CounterFamily]:
        return [f for f in self._families.values()
                if isinstance(f, CounterFamily)]

    def scrape(self) -> str:
        """Prometheus text-format exposition of every family."""
        lines: list[str] = []
        for name in sorted(self._families):
            lines.extend(self._families[name].expose())
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def counter(name: str, help: str = "") -> CounterFamily:
    return _DEFAULT.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _DEFAULT.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return _DEFAULT.histogram(name, help, buckets)


def scrape() -> str:
    return _DEFAULT.scrape()


def set_metrics_enabled(flag: bool) -> None:
    """Toggle the warm-path instruments (histograms). Counters are
    unaffected — the CI work-counter gates consume them unconditionally."""
    _DEFAULT.enabled = bool(flag)


def metrics_enabled() -> bool:
    return _DEFAULT.enabled


@contextlib.contextmanager
def scoped_counters(*families: CounterFamily):
    """Bracket a run so its counts are independent of process history.

    Inside the ``with``, the given families (default: every counter
    family in the default registry) read as if the process had just
    started — two back-to-back simulations each see exactly their own
    activity. On exit the pre-scope counts are ADDED back, so the
    process totals equal pre-scope + in-scope and nothing is lost::

        with scoped_counters(DISPATCH_COUNTS):
            simulate(trace, method)
            launches = DISPATCH_COUNTS["predict_pool"]   # this run only
    """
    fams = families or tuple(_DEFAULT.counters())
    saved = [(f, dict(f)) for f in fams]
    for f in fams:
        f.clear()
    try:
        yield fams if len(fams) != 1 else fams[0]
    finally:
        for f, pre in saved:
            f.update(pre)
