"""The three Witt et al. baselines (paper §III-B).

WittPercentile / WittLR — Witt, Wagner, Leser, "Feedback-based resource
allocation for batch scheduling of scientific workflows" (HPCS 2019).
Reimplemented from the paper description (no public code, as in the Sizey
paper itself).

WittWastage — Witt, van Santen, Leser, "Learning low-wastage memory
allocations for scientific workflows at IceCube" (HPCS 2019): a linear
model whose parameters minimize *retrospective wastage* (with the doubling
retry ladder priced in) rather than the squared prediction error. We search
intercepts over the residual quantiles of the OLS fit — the paper's
"quantile regression lines" — and keep the least-wasteful line.
"""
from __future__ import annotations

import numpy as np

from repro_torch.baselines.common import HistoryMethod
from repro_torch.workflow.trace import TaskInstance


def _ols(xs: np.ndarray, ys: np.ndarray) -> tuple[float, float]:
    """Least-squares line y = a x + b (falls back to mean for flat xs)."""
    if xs.size < 2 or np.ptp(xs) < 1e-12:
        return 0.0, float(np.mean(ys))
    a, b = np.polyfit(xs, ys, 1)
    return float(a), float(b)


class WittPercentile(HistoryMethod):
    """P95 of historical peaks; conservative, few failures (Fig. 8c)."""

    name = "witt_percentile"

    def __init__(self, machine_cap_gb: float = 128.0,
                 percentile: float = 95.0, **kw):
        super().__init__(machine_cap_gb, **kw)
        self.percentile = percentile

    def allocate(self, task: TaskInstance) -> float:
        _, ys, _ = self.history(task)
        cap = self.cap_for(task)
        if ys.size < self.min_history:
            return min(task.user_preset_gb, cap)
        return float(min(np.percentile(ys, self.percentile), cap))


class WittLR(HistoryMethod):
    """Linear regression on input size + offset (std of residuals)."""

    name = "witt_lr"

    def allocate(self, task: TaskInstance) -> float:
        xs, ys, _ = self.history(task)
        cap = self.cap_for(task)
        if ys.size < self.min_history:
            return min(task.user_preset_gb, cap)
        a, b = _ols(xs, ys)
        resid = ys - (a * xs + b)
        pred = a * task.input_size_gb + b + float(np.std(resid))
        return float(np.clip(pred, 0.125, cap))


class WittWastage(HistoryMethod):
    """Low-wastage linear regression with doubling priced into the objective."""

    name = "witt_wastage"

    def __init__(self, machine_cap_gb: float = 128.0, ttf: float = 1.0,
                 **kw):
        super().__init__(machine_cap_gb, **kw)
        self.ttf = ttf

    def _wastage_of_line(self, a: float, b: float, xs, ys, rts,
                         cap: float) -> float:
        """Retrospective wastage of allocating a*x+b with doubling retries."""
        total = 0.0
        for x, y, rt in zip(xs, ys, rts):
            alloc = max(a * x + b, 0.125)
            waste = 0.0
            while alloc < y and alloc < cap:
                waste += alloc * self.ttf * rt
                alloc = min(alloc * 2.0, cap)
            waste += max(alloc - y, 0.0) * rt
            total += waste
        return total

    def allocate(self, task: TaskInstance) -> float:
        xs, ys, rts = self.history(task)
        cap = self.cap_for(task)
        if ys.size < self.min_history:
            return min(task.user_preset_gb, cap)
        a, b0 = _ols(xs, ys)
        resid = ys - (a * xs + b0)
        # candidate intercept shifts: residual quantiles (incl. the max)
        qs = np.quantile(resid, [0.0, 0.25, 0.5, 0.75, 0.9, 0.95, 1.0])
        best_b, best_w = b0, np.inf
        for dq in qs:
            w = self._wastage_of_line(a, b0 + dq, xs, ys, rts, cap)
            if w < best_w:
                best_w, best_b = w, b0 + dq
        pred = a * task.input_size_gb + best_b
        return float(np.clip(pred, 0.125, cap))
