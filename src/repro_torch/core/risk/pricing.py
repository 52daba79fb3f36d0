"""Risk pricing: (uncertainty band, cluster pressure, crash exposure) ->
reservation quantile, plus the per-pool failure-strategy auto-selection
that rides the same signals.

The paper's offset answers "how much headroom" with a scalar blind to
context. The pricing rule makes the *coverage level* itself the control
variable:

  * **spare capacity sizes generously** — with no queue backlog and free
    memory, an OOM retry is pure waste while headroom is nearly free, so
    the reservation quantile sits at ``tau_max``;
  * **queue pressure sizes tight** — when the cluster is saturated every
    reserved-but-unused GB delays another tenant's dispatch, so the
    quantile is squeezed toward ``tau_min`` and the method leans on the
    failure strategies (checkpoint retention, re-sized retries) to make
    the occasional kill cheap;
  * **crash exposure squeezes too** — headroom on a crashy cluster is
    burned again and again by interruptions before it ever prevents an
    OOM (the crash-aware offset's argument), so the expected
    crashes-per-attempt probability joins the squeeze.

Every function here is a pure deterministic function of its arguments —
no rng, no clock — so journal replay and re-executed sizing waves
reproduce each priced quantile bitwise.
"""
from __future__ import annotations

import math

__all__ = ["crash_probability", "price_quantile", "select_strategy",
           "checkpoint_frac_for"]


def crash_probability(crash_events: int, exposure_h: float,
                      runtime_sum_h: float, n_completed: int) -> float:
    """Probability the next attempt is interrupted at least once:
    ``1 - exp(-rate x mean_runtime)`` from the observed interruption
    rate (crashes per attempt-hour of exposure) and the mean completed
    runtime — the same fold the crash-aware offset uses. 0.0 with no
    observed crash, so failure-free runs price crash-free."""
    if crash_events <= 0:
        return 0.0
    rate_per_h = crash_events / max(exposure_h, 1e-9)
    mean_rt = runtime_sum_h / max(n_completed, 1)
    return 1.0 - math.exp(-rate_per_h * mean_rt)


def price_quantile(cfg, pressure: float, crash_p: float) -> float:
    """Map live cluster pressure and crash exposure to the reservation
    quantile: ``tau_max`` under spare capacity, squeezed linearly toward
    ``tau_min`` as ``pressure_gain * pressure + crash_gain * crash_p``
    approaches 1."""
    squeeze = cfg.pressure_gain * float(pressure) \
        + cfg.crash_gain * float(crash_p)
    squeeze = min(max(squeeze, 0.0), 1.0)
    return cfg.tau_max - (cfg.tau_max - cfg.tau_min) * squeeze


def select_strategy(cfg, crash_p: float, raq: float | None) -> str:
    """Per-pool failure-strategy auto-selection (RAQ x crash exposure).

    * Frequent interruptions (``crash_p >= checkpoint_crash_p``):
      ``checkpoint`` — retained work is worth the cadence overhead when
      most attempts will be cut at least once.
    * Some crash exposure and a *trusted* pool (best RAQ at or above
      ``raq_trust``): ``retry_scaled`` — re-sizing an interrupted task
      through a predictor that is demonstrably accurate shrinks what the
      next crash can burn.
    * Otherwise ``retry_same`` — with no crash signal (or an untrusted
      pool whose re-size could undercut), the pre-strategy semantics.

    Pure function of (crash counters, decision RAQ): the engine journals
    the choice per sized task, so replay never re-asks."""
    if crash_p >= cfg.checkpoint_crash_p:
        return "checkpoint"
    if crash_p > 0.0 and raq is not None and raq >= cfg.raq_trust:
        return "retry_scaled"
    return "retry_same"


def checkpoint_frac_for(cfg, crash_p: float) -> float:
    """Crash-rate-driven checkpoint cadence: the fraction of runtime
    between checkpoints shrinks linearly from ``max_checkpoint_frac``
    (calm cluster, cheap cadence) to ``min_checkpoint_frac`` (crashy
    cluster, checkpoint often) as the interruption probability grows.
    Written as a two-point lerp so both endpoints are float-exact."""
    c = min(max(crash_p, 0.0), 1.0)
    return (1.0 - c) * cfg.max_checkpoint_frac + c * cfg.min_checkpoint_frac
