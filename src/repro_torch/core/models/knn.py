"""k-nearest-neighbours regression over the masked history buffer.

The model keeps the buffers and a per-feature scale (the feature's std);
``predict_batch`` is one call of the fused k-NN kernel
(:mod:`repro_torch.kernels.knn`): scaled distances, the k nearest with
ties to the lowest index, and the mean of their targets.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.config import SizeyConfig
from repro_torch.kernels.knn.ops import knn_predict

_EPS = 1e-9


class KNNState(NamedTuple):
    xs: torch.Tensor     # (CAP, d) raw features
    ys: torch.Tensor     # (CAP,)
    mask: torch.Tensor   # (CAP,)
    scale: torch.Tensor  # (d,) per-feature std for distance normalization


def _feature_scale(xs, mask):
    n = mask.sum().clamp_min(1.0)
    mu = (xs * mask[:, None]).sum(0) / n
    var = (((xs - mu) ** 2) * mask[:, None]).sum(0) / n
    return var.sqrt() + _EPS


def fit(xs, ys, mask, key, cfg: SizeyConfig) -> KNNState:
    # a snapshot: the provenance buffers are appended in place, and the
    # state must keep the history it was fit on (the reference's arrays
    # are immutable)
    return KNNState(xs.clone(), ys.clone(), mask.clone(),
                    _feature_scale(xs, mask))


def update(state: KNNState, xs, ys, mask, new_idx: int, key,
           cfg: SizeyConfig) -> KNNState:
    # instance-based: "update" = take the refreshed buffers
    return fit(xs, ys, mask, key, cfg)


def predict_batch(state: KNNState, xq: torch.Tensor, *,
                  k: int = 5) -> torch.Tensor:
    """(K, d) -> (K,)."""
    return knn_predict(xq.contiguous(), state.xs, state.ys, state.mask,
                       state.scale, k)
