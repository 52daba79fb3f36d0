"""Gating over the model pool (paper §II-D, Fig. 6), in torch.

``argmax`` puts weight 1 on the highest-RAQ model (ties go to the lowest
model index, as ``torch.argmax`` returns the first maximum);
``interpolation`` weighs the models by softmax(beta * RAQ) (Eq. 4). Both
work over the last axis, so a batch of decisions gates in one call.
"""
from __future__ import annotations

import torch


def gate_weights(raq: torch.Tensor, strategy: str,
                 beta: float) -> torch.Tensor:
    """The weight vector(s) over the last axis for the given strategy."""
    if strategy == "argmax":
        return torch.nn.functional.one_hot(
            raq.argmax(-1), raq.shape[-1]).to(raq.dtype)
    if strategy == "interpolation":
        return torch.softmax(beta * raq, dim=-1)
    raise ValueError(f"unknown gating strategy {strategy!r}")


def gate_predictions(preds: torch.Tensor, raq: torch.Tensor, strategy: str,
                     beta: float) -> torch.Tensor:
    """Aggregate model predictions into one estimate (Eq. 4)."""
    return (preds * gate_weights(raq, strategy, beta)).sum(-1)
