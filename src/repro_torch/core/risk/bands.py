"""Calibrated uncertainty bands from the fused ensemble's prequential log.

The pool buffers (:class:`repro_torch.core.provenance._PoolBuffers`) already
carry, on the device, everything a rolling conformal layer needs: for every
completion where Sizey really predicted, the per-model predictions
(``log_model_preds``), the RAQ-weighted aggregate (``log_agg``) and the
observed peak (``log_actual``). The *residuals* ``r_j = actual_j -
agg_j`` are the prequential under-prediction record of that pool — each
one was computed before its observation entered the history, so the
empirical quantile of ``r`` is a split-conformal upper band for the next
prediction of the same pool (exchangeability within a pool is the same
assumption the paper's offset already makes).

Numerical contract: everything here is a **pure host-side function of
the pool's log state** — the float32 device buffers brought to the host,
then widened to float64 (bitwise the reference's float64 reads of the
same float32 values), no rng, ``method="higher"`` quantiles (an actual
sample value, no interpolation arithmetic). A warm-resumed predictor bulk-loads the
identical log, so a re-executed sizing wave reproduces every band
bitwise (the kill-at-any-byte invariant the risk aux rows rely on).

The band has two terms:

  * **conformal term** — the ``tau``-quantile of the pool's residuals,
    clamped at 0 (a pool that never under-predicts needs no headroom
    from history);
  * **spread term** — the standard deviation of the CURRENT decision's
    per-model predictions, scaled by ``spread_coef``. Model disagreement
    is the in-advance uncertainty signal the residual log cannot see
    yet; when the RAQ gate leaves effectively one model (all survivors
    agree) the spread is exactly zero and the band degrades gracefully
    to the pure conformal quantile (pinned in ``tests/test_torch_risk.py``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pool_residuals", "conformal_band", "ensemble_spread"]


def _log_rows(pool, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``n`` observed peaks and aggregates of a pool's log as
    float64: device buffers come to the host in one float32 copy and are
    widened there; host arrays (a numpy pool) are widened in place."""
    actual, agg = pool.log_actual[:n], pool.log_agg[:n]
    if isinstance(actual, torch.Tensor):
        actual, agg = torch.stack((actual, agg)).cpu().numpy()
    return np.asarray(actual, np.float64), np.asarray(agg, np.float64)


def pool_residuals(pool) -> np.ndarray:
    """Signed prequential residuals ``actual - agg`` of one pool's log
    (positive = the aggregate under-predicted), float64, oldest first.
    Empty array for a pool that has no prequential rows yet."""
    n = int(pool.log_count)
    if n == 0:
        return np.zeros((0,), np.float64)
    actual, agg = _log_rows(pool, n)
    return actual - agg


def conformal_band(residuals: np.ndarray, tau: float,
                   window: int | None = None) -> float:
    """Upper ``tau``-quantile of the residuals, clamped at 0.

    ``method="higher"`` returns an actual sample (conservative side, and
    no interpolation arithmetic to drift across platforms). ``window``
    keeps the band *rolling*: only the newest ``window`` residuals count,
    so a pool whose model suddenly improves sheds stale headroom."""
    if len(residuals) == 0:
        return 0.0
    if window is not None and len(residuals) > window:
        residuals = residuals[-window:]
    q = float(np.quantile(residuals, float(tau), method="higher"))
    return max(q, 0.0)


def ensemble_spread(model_preds) -> float:
    """Population standard deviation of one decision's per-model
    predictions (float64): the ensemble-disagreement width. 0.0 when the
    decision carries no per-model predictions (preset path) or all
    models agree (single-model-surviving RAQ gate)."""
    if model_preds is None or len(model_preds) == 0:
        return 0.0
    return float(np.std(np.asarray(model_preds, np.float64)))
