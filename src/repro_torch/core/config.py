"""Configuration for the Sizey predictor (paper §II)."""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class SizeyConfig:
    """Hyperparameters of Sizey.

    alpha:   RAQ trade-off (Eq. 3). 0 → pure accuracy, 1 → pure efficiency.
             The paper's evaluation uses alpha = 0.0.
    beta:    softmax temperature for the Interpolation strategy (Eq. 4).
    strategy: "interpolation" (paper default in evaluation) or "argmax".
    incremental: online update instead of full retrain (paper §III-D).
    offset_strategies: candidate offsets; the dynamic selector picks the one
             with the least retrospective wastage (paper §II-E).
    """

    alpha: float = 0.0
    # adaptive alpha (beyond-paper: the paper's §III-E names this as future
    # work): per pool, pick alpha from ALPHA_GRID by least retrospective
    # wastage of the alpha-gated aggregate over the prequential log.
    adaptive_alpha: bool = False
    beta: float = 16.0
    strategy: str = "interpolation"  # "argmax" | "interpolation"
    incremental: bool = False
    hpo: bool = True  # hyperparameter optimization on full retrain
    offset_strategies: Sequence[str] = (
        "std",
        "std_under",
        "median_err",
        "median_err_under",
    )
    # model classes in the pool (paper Fig. 5)
    model_classes: Sequence[str] = ("linear", "knn", "mlp", "forest")
    # minimum completed executions of a task type before Sizey predicts;
    # below this the user preset is used (paper §I: unknown task types go
    # straight to the resource manager with the user estimate).
    min_history: int = 3
    # MLP
    mlp_hidden: int = 32
    mlp_train_steps: int = 300
    mlp_incremental_steps: int = 12
    # forest
    forest_trees: int = 8
    forest_depth: int = 3
    # knn
    knn_k: int = 5
    # amortized refit schedule (full-retrain mode only): 0.0 refits every
    # observe (the paper's online loop, bitwise-pinned default); r > 0
    # refits a pool only once its history has grown by a fraction r since
    # the last fit (plus forced refits on buffer growth), running a cheap
    # fused refresh in between that keeps the in-sample predictions and
    # the decision cache (offsets, adaptive alpha) fresh against slightly
    # stale model states — O(log n) retrains per pool instead of O(n).
    # The temporal subsystem turns this on for k > 1 (see
    # repro.core.temporal.predictor.TEMPORAL_REFIT_GROWTH).
    refit_growth: float = 0.0
    # ridge
    ridge_lambda: float = 1e-4
    # final allocation is clamped to [min_alloc_gb, machine_cap]
    min_alloc_gb: float = 0.125
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"alpha must be in [0,1], got {self.alpha}")
        if self.beta < 1.0:
            raise ValueError(f"beta must be >= 1, got {self.beta}")
        if self.strategy not in ("argmax", "interpolation"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.refit_growth < 0.0:
            raise ValueError(
                f"refit_growth must be >= 0, got {self.refit_growth}")
