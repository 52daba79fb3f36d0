"""KS+ — Bader, Lößer, Thamsen, Scheuermann, Kao, "KS+: Predicting
Workflow Task Memory Usage Over Time" (arXiv 2408.12290).

KS+ segments a task's memory usage over its runtime into k segments and
allocates each segment from a per-segment predictor, so the reservation
follows the usage ramp instead of sitting at the peak for the whole run.
Reimplemented from the paper description (no public code vendored), with
the same adaptations the other baselines get:

  * segment boundaries come from the shared vectorized change-point sweep
    (:func:`repro_torch.core.temporal.segments.fit_boundaries`) over the
    pool's observed usage profiles — the k-segments step of the paper;
  * each segment's peak is predicted by a linear model on input size over
    the pool's historical per-segment peaks, padded by the standard
    deviation of its *underprediction* residuals (the paper's offsetting
    of segment predictions to absorb variance); with degenerate history
    the segment falls back to the max observed segment peak;
  * below ``min_history`` completed tasks the user preset is allocated
    flat, exactly like every other baseline's cold start;
  * failure handling is the common doubling retry ladder (flat retries —
    a plan that OOMed is not re-trusted), clamped to the machine/node cap.

The method exposes ``plan_for`` so both engines execute the k-segment
reservation with RESIZE events; engines without plan support still get a
safe peak-level allocation (``allocate`` returns the plan max).

A copy of the reference's ``repro.baselines.ks_plus``, except that the
boundary fits run on ``device`` (CUDA unless the caller asks for another)
through the segment-DP kernel; everything else is numpy, so the results
are the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.baselines.common import HistoryMethod
from repro_torch.core.temporal.segments import (PROFILE_WINDOW,
                                                ReservationPlan,
                                                fit_boundaries, grid_profile,
                                                segment_peaks,
                                                uniform_boundaries)
from repro_torch.utils.misc import resolve_device
from repro_torch.workflow.trace import TaskInstance


class KSPlusMethod(HistoryMethod):
    name = "ks_plus"

    def __init__(self, machine_cap_gb: float = 128.0, *,
                 k_segments: int = 4, n_grid: int = 32,
                 min_alloc_gb: float = 0.125, device=None, **kw):
        super().__init__(machine_cap_gb, **kw)
        self.device = resolve_device(device)
        self.k = int(k_segments)
        self.n_grid = int(n_grid)
        self.min_alloc_gb = float(min_alloc_gb)
        # (input_gb, grid profile) pairs, windowed — kept together so the
        # per-segment regressions always see aligned inputs/targets
        self._profiles: dict[tuple[str, str],
                             list[tuple[float, np.ndarray]]] = {}
        self._plans: dict[int, ReservationPlan | None] = {}
        # boundary fit + fitted per-segment models; complete() invalidates
        # on every new profile (NOT keyed on len(pairs) — the window
        # saturates at PROFILE_WINDOW, which would freeze the cache), so
        # allocate() is O(k) evaluation, one refit per completion
        self._seg_cache: dict[tuple[str, str], tuple[tuple, list]] = {}

    def _segments_for(self, key: tuple[str, str]) -> tuple[tuple, list]:
        """(boundaries, per-segment models), refit only on new history.

        A segment model is ``("ols", a, b, offset)`` — OLS on input size
        plus the std of its underprediction residuals (the paper's offset
        against segment variance) — or ``("max", v)`` when the inputs are
        degenerate (fall back to the max observed segment peak)."""
        pairs = self._profiles[key]
        cached = self._seg_cache.get(key)
        if cached is not None:
            return cached
        xs = np.asarray([x for x, _ in pairs])
        P = np.stack([p for _, p in pairs])
        bounds = (fit_boundaries(P, self.k, device=self.device)
                  if self.k > 1 else uniform_boundaries(1))
        seg_hist = np.stack([segment_peaks(p, bounds) for p in P])  # (M, k)
        models = []
        for s in range(len(bounds)):
            peaks = seg_hist[:, s]
            if xs.size >= 2 and np.ptp(xs) > 1e-12:
                a, b = np.polyfit(xs, peaks, 1)
                resid = peaks - (a * xs + b)
                under = resid[resid > 0]
                off = float(np.std(under)) if under.size \
                    else float(np.std(resid))
                models.append(("ols", float(a), float(b), off))
            else:
                models.append(("max", float(np.max(peaks))))
        self._seg_cache[key] = (bounds, models)
        return bounds, models

    # SizingMethod protocol -------------------------------------------------
    def allocate(self, task: TaskInstance) -> float:
        cap = self.cap_for(task)
        key = self._key(task)
        if len(self._profiles.get(key, ())) < self.min_history:
            self._plans[id(task)] = None
            return min(task.user_preset_gb, cap)
        bounds, models = self._segments_for(key)
        x = task.input_size_gb
        allocs = tuple(
            float(np.clip(m[1] * x + m[2] + m[3] if m[0] == "ols" else m[1],
                          self.min_alloc_gb, cap))
            for m in models)
        plan = ReservationPlan(tuple(zip(bounds, allocs)))
        self._plans[id(task)] = plan
        return plan.peak_gb

    def plan_for(self, task: TaskInstance) -> ReservationPlan | None:
        return self._plans.get(id(task))

    def complete(self, task: TaskInstance, first_alloc_gb: float,
                 attempts: int) -> None:
        super().complete(task, first_alloc_gb, attempts)
        key = self._key(task)
        pairs = self._profiles.setdefault(key, [])
        pairs.append((task.input_size_gb,
                      grid_profile(task.usage_curve, self.n_grid,
                                   peak_gb=task.actual_peak_gb)))
        del pairs[:-PROFILE_WINDOW]
        self._seg_cache.pop(key, None)   # refit on next allocate
        self._plans.pop(id(task), None)

    def abandon(self, task: TaskInstance) -> None:
        self._plans.pop(id(task), None)
