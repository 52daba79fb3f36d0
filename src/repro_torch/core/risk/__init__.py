"""Risk-priced uncertainty-aware sizing: the port of the reference's
``repro.core.risk`` (host arithmetic over the pool's prequential log; it
launches nothing on the device).

Sizey's dynamic offset hedges under-prediction with a scalar chosen to
minimize *retrospective* wastage — blind to how uncertain the current
prediction is and to how expensive an OOM is right now. This package
closes that loop with the live signals of the cluster engine and the
provenance log:

  * :mod:`~repro_torch.core.risk.bands` — calibrated uncertainty bands: a
    rolling split-conformal quantile over the pool's prequential
    residual log (already on device in ``_PoolBuffers``) widened by the
    current decision's ensemble spread;
  * :mod:`~repro_torch.core.risk.pricing` — the pricing rule mapping (band,
    live cluster pressure, observed crash exposure) to the reservation
    quantile, plus per-pool failure-strategy auto-selection and the
    crash-rate-driven checkpoint cadence;
  * :class:`RiskManager` — the per-method stateful facade
    :class:`~repro_torch.baselines.sizey_method.SizeyMethod` wires in via
    ``SizeyMethod(risk=...)``.

Determinism contract (the acceptance invariant): a risk-priced
allocation is a pure function of (pool residual log, decision, pressure
sample, crash counters). The log is journal-restored, the pressure
sample is a pure function of live engine state, and the crash counters
ride ``export_state`` — so a repaired journal's re-executed sizing wave
reprices every task bitwise, and ``risk=None`` leaves every code path
byte-identical to the paper offset (both pinned in
``tests/test_torch_risk.py``).

Reading a pool's log brings its float32 rows to the host, which waits for
the device's queue: :data:`RESIDUAL_READS` counts those reads (``reads``)
and the rows they carried (``rows``).
"""
from __future__ import annotations

import collections
import dataclasses

from repro_torch.core.risk.bands import (conformal_band,
                                         ensemble_spread, pool_residuals)
from repro_torch.core.risk.pricing import (checkpoint_frac_for,
                                           crash_probability,
                                           price_quantile, select_strategy)
from repro_torch.obs import metrics as _obs_metrics

__all__ = ["RiskConfig", "RiskManager", "RESIDUAL_READS", "pool_residuals",
           "conformal_band", "ensemble_spread", "crash_probability",
           "price_quantile", "select_strategy", "checkpoint_frac_for"]

# device->host reads of a pool's prequential log (cache misses of
# RiskManager.residuals) and the rows they carried
RESIDUAL_READS: collections.Counter = _obs_metrics.counter(
    "risk_residual_reads_total", "pool residual-log reads to the host")


@dataclasses.dataclass(frozen=True)
class RiskConfig:
    """Knobs of the risk-priced sizing layer (all deterministic).

    ``tau_min``/``tau_max`` bound the reservation quantile the pricing
    rule may choose; ``min_samples`` is the residual-log size below
    which a pool is *cold* and falls back to the paper offset bitwise;
    ``window`` keeps the conformal layer rolling. The strategy
    thresholds drive :func:`~repro_torch.core.risk.pricing.select_strategy`
    (used only under ``failure_strategy="auto"``)."""
    tau_min: float = 0.60          # quantile under full squeeze
    tau_max: float = 0.95          # quantile under spare capacity
    min_samples: int = 5           # residual rows before bands switch on
    window: int = 256              # rolling conformal window
    spread_coef: float = 1.0       # ensemble-disagreement widening
    pressure_gain: float = 0.8     # how hard backlog squeezes tau
    crash_gain: float = 0.8        # how hard crash exposure squeezes tau
    # failure-strategy auto-selection (failure_strategy="auto")
    checkpoint_crash_p: float = 0.25
    raq_trust: float = 0.5
    min_checkpoint_frac: float = 0.05
    max_checkpoint_frac: float = 0.50
    # per-pool temporal k: a multi-segment plan whose segment values vary
    # less than this fraction of the pool's band collapses to flat (k=1)
    k_collapse_frac: float = 0.5

    def __post_init__(self):
        if not (0.0 < self.tau_min <= self.tau_max < 1.0):
            raise ValueError(f"need 0 < tau_min <= tau_max < 1, got "
                             f"[{self.tau_min}, {self.tau_max}]")
        if self.min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, "
                             f"got {self.min_samples}")
        if self.window < self.min_samples:
            raise ValueError("window must be >= min_samples")
        if not (0.0 < self.min_checkpoint_frac
                <= self.max_checkpoint_frac <= 1.0):
            raise ValueError("need 0 < min_checkpoint_frac <= "
                             "max_checkpoint_frac <= 1")


class RiskManager:
    """Per-method risk state: the residual cache plus the pricing calls.

    The cache is keyed by (pool key, log length): a pool's sorted
    residual view is recomputed only when its prequential log grew, so a
    scheduling wave of K same-pool tasks reads the log buffers once —
    the host-side analogue of the predictor's decision cache. The cache
    is pure memoization of journal-restorable pool state (never
    serialized), so bands after a warm-start replay are bitwise the
    uninterrupted run's — deterministic, rng-free host arithmetic."""

    def __init__(self, cfg: RiskConfig | None = None):
        self.cfg = cfg or RiskConfig()
        self._cache: dict[tuple[str, str], tuple[int, object]] = {}

    def residuals(self, key, pool):
        """Cached residual array of one pool (None when the pool is
        missing or its log is below ``min_samples`` — the cold path)."""
        if pool is None:
            return None
        n = int(pool.log_count)
        if n < self.cfg.min_samples:
            return None
        hit = self._cache.get(key)
        if hit is not None and hit[0] == n:
            return hit[1]
        res = pool_residuals(pool)
        RESIDUAL_READS["reads"] += 1
        RESIDUAL_READS["rows"] += n
        self._cache[key] = (n, res)
        return res

    def quantile(self, pressure: float, crash_p: float) -> float:
        """The priced reservation quantile for the current conditions."""
        return price_quantile(self.cfg, pressure, crash_p)

    def band(self, key, pool, tau: float, model_preds) -> float | None:
        """Band width in GB for one decision (None on the cold path):
        rolling conformal quantile of the pool's residuals at ``tau``
        plus the spread-widening term of THIS decision's ensemble."""
        res = self.residuals(key, pool)
        if res is None:
            return None
        band = conformal_band(res, tau, window=self.cfg.window)
        return band + self.cfg.spread_coef * ensemble_spread(model_preds)

    def collapse_temporal(self, seg_values, band_gb: float) -> bool:
        """Per-pool temporal k selection: True when the plan's temporal
        structure (max minus min segment reservation) is smaller than
        ``k_collapse_frac`` of the pool's calibrated band — the segment
        differences are then noise relative to the pool's uncertainty,
        so the plan should run flat (k collapses to 1 for this pool
        until its calibration tightens or its profile steepens)."""
        if band_gb <= 0.0 or len(seg_values) <= 1:
            return False
        return (max(seg_values) - min(seg_values)) \
            < self.cfg.k_collapse_frac * band_gb
