"""Sizey core: online multi-model memory prediction (the paper's
contribution), in torch.

Public API:
    SizeyPredictor  — per (task-type × machine) model pool with RAQ gating
    SizeyConfig     — hyperparameters (alpha, beta, strategy, offsets, ...)
    accuracy_score / efficiency_scores / raq_scores — paper Eq. 1-3
"""
from repro_torch.core.config import SizeyConfig
from repro_torch.core.raq import accuracy_score, efficiency_scores, raq_scores
from repro_torch.core.gating import gate_predictions
from repro_torch.core.offsets import OFFSET_STRATEGIES, select_offset
from repro_torch.core.predictor import SizeyPredictor, TaskQuery
from repro_torch.core.provenance import ProvenanceDB, TaskRecord
