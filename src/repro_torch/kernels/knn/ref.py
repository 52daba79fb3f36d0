"""Plain PyTorch version of the k-NN kernel.

Features are summed in order, one at a time, and the k nearest are taken
with a stable sort (lowest index first on ties, as ``jax.lax.top_k``
keeps them; ``torch.topk`` does not), and their targets are summed nearest
first: on the card the kernel's results are then bitwise these.
"""
from __future__ import annotations

import torch

INF = 3.4e38


def _scaled_sq_dists(queries, hist, scale):
    d2 = torch.zeros((queries.shape[0], hist.shape[0]),
                     dtype=torch.float32, device=queries.device)
    for f in range(queries.shape[1]):
        diff = (hist[None, :, f] - queries[:, None, f]) / scale[f]
        d2 = d2 + diff * diff
    return d2


def pairwise_sq_dists_ref(queries, hist, mask):
    """(Q,d), (T,d), (T,) -> (Q,T) squared distances, 3.4e38 at masked
    columns (the reference TPU kernel's function)."""
    d2 = torch.zeros((queries.shape[0], hist.shape[0]),
                     dtype=torch.float32, device=queries.device)
    for f in range(queries.shape[1]):
        diff = queries[:, None, f] - hist[None, :, f]
        d2 = d2 + diff * diff
    return torch.where(mask[None, :] > 0, d2,
                       torch.full_like(d2, INF))


def nearest_ref(d2, k: int):
    """The k smallest entries of each row of ``d2`` and their indices,
    lowest index first among equal distances (``jax.lax.top_k``'s order)."""
    sd, idx = torch.sort(d2, dim=-1, stable=True)
    kk = min(k, d2.shape[-1])
    return sd[:, :kk], idx[:, :kk]


def knn_predict_ref(queries, hist, ys, mask, scale, k: int):
    """Mean target of the k nearest valid history rows per query (0 when
    none is valid); distances are ``sum_f ((hist_f - q_f) / scale_f)^2``."""
    d2 = _scaled_sq_dists(queries, hist, scale)
    d2 = torch.where((mask > 0)[None, :] & ~torch.isnan(d2), d2,
                     torch.full_like(d2, torch.inf))
    sd, idx = nearest_ref(d2, k)
    kk = sd.shape[-1]
    valid = torch.isfinite(sd)
    vals = torch.where(valid, ys[idx], torch.zeros_like(sd))
    total = torch.zeros(d2.shape[0], dtype=torch.float32, device=d2.device)
    for j in range(kk):
        total = total + vals[:, j]
    return total / valid.sum(-1).clamp_min(1).to(torch.float32)
