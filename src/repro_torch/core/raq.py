"""Resource Allocation Quality score (paper §II-C, Eq. 1-3), in torch.

Scores are in [0, 1] (1 = best). The accuracy score is prequential over
the recorded predictions; see ``repro.core.raq`` for the derivation.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def accuracy_score(preds: torch.Tensor, actuals: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Eq. 1 — mean bounded relative error, per model.

    preds (N_models, CAP), actuals (CAP,), mask (CAP,) -> (N_models,).
    An empty history scores 1.0 for every model."""
    rel_err = (preds - actuals[None, :]).abs() \
        / actuals[None, :].clamp_min(_EPS)
    bounded = rel_err.clamp_max(1.0)
    n = mask.sum().clamp_min(1.0)
    return 1.0 - (bounded * mask[None, :]).sum(-1) / n


def efficiency_scores(preds: torch.Tensor) -> torch.Tensor:
    """Eq. 2 — ES_i = 1 - y_hat_i / max_j y_hat_j over the last axis.
    Negative predictions are clamped to 0 first."""
    p = preds.clamp_min(0.0)
    return 1.0 - p / p.amax(-1, keepdim=True).clamp_min(_EPS)


def raq_scores(acc: torch.Tensor, eff: torch.Tensor,
               alpha) -> torch.Tensor:
    """Eq. 3 — RAQ_i = (1 - alpha) * AS_i + alpha * ES_i."""
    return (1.0 - alpha) * acc + alpha * eff
