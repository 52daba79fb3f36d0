"""Random-forest regression as an ensemble of *oblivious* trees.

One (feature, threshold) pair per tree level, shared across the level, so
prediction is a bit-packed comparison and a leaf-table gather, and
training is an exhaustive scan over candidate thresholds per level. The
trees grow together as one batch dimension; the candidate thresholds are
the masked per-feature quantiles, and each tree is weighted by a Poisson(1)
bootstrap drawn from the fit's key (:func:`repro_torch.core.prng.poisson`,
equal to the reference's ``jax.random.poisson``).

Segment sums are one-hot reductions over at most 2^depth segments, not
scatter-adds: CUDA's atomic ``index_add_`` sums in an order that changes
from run to run, and a split choice must not. The incremental update keeps
the structure and refreshes the leaf means from the whole buffer.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.config import SizeyConfig
from repro_torch.utils.misc import device_constant

_EPS = 1e-9
N_QUANTILES = 16
# the reference's jnp.linspace(0.05, 0.95, 16) in float32, bit for bit
# (XLA's CPU backend fuses a multiply-add in it; one level differs by an
# ulp from the unfused formula)
_QUANTILE_BITS = (1028443341, 1038174126, 1043207291, 1047233822,
                  1049918177, 1051931443, 1053944709, 1055957975,
                  1057467924, 1058474557, 1059481190, 1060487823,
                  1061494456, 1062501089, 1063507722, 1064514355)
QUANTILE_LEVELS = tuple(
    float(v) for v in np.asarray(_QUANTILE_BITS, np.int32).view(np.float32))


class ForestState(NamedTuple):
    feat: torch.Tensor       # (T, D) int64 — split feature per tree level
    thresh: torch.Tensor     # (T, D) float32 — split threshold per level
    leaf_vals: torch.Tensor  # (T, 2^D) float32 — leaf means
    global_mean: torch.Tensor


def _candidate_thresholds(xs, mask):
    """(d, Q) candidate thresholds = masked per-feature quantiles (linear
    interpolation, NaN where a feature has no valid row)."""
    qs = device_constant(QUANTILE_LEVELS, xs.device)
    a = torch.where(mask[:, None] > 0, xs, torch.nan).sort(dim=0).values
    counts = (~torch.isnan(a)).sum(0).to(torch.float32)       # (d,)
    q = qs[:, None] * (counts[None, :] - 1.0)                  # (Q, d)
    low, high = q.floor(), q.ceil()
    hw = q - low
    lw = 1.0 - hw
    top = counts[None, :] - 1.0
    low = torch.maximum(torch.minimum(low, top), torch.zeros_like(low))
    high = torch.maximum(torch.minimum(high, top), torch.zeros_like(high))
    lv = a.gather(0, low.to(torch.int64))
    hv = a.gather(0, high.to(torch.int64))
    # hv * hw + lv * lw with the first product fused, as the reference's
    # CPU lowering computes it (a float64 product of two float32 values is
    # exact, so one float64 add and one rounding give the fused result)
    res = (hv.double() * hw.double() + (lv * lw).double()).float()
    return res.T


def _segment_sums(seg, n_seg: int, *values):
    """Per-segment sums of each (..., CAP) ``value`` under integer segment
    ids ``seg`` (..., CAP), as a deterministic one-hot reduction."""
    onehot = (seg[..., None] == torch.arange(n_seg, device=seg.device)
              ).to(torch.float32)
    return [(onehot * v[..., None]).sum(-2) for v in values]


def _leaf_means(leaf, w, ys, n_leaves: int, fallback):
    sw, swy = _segment_sums(leaf, n_leaves, w, w * ys)
    return torch.where(sw > _EPS, swy / sw.clamp_min(_EPS), fallback)


def _grow(w, xs, ys, cands, depth: int):
    """Grow every tree at once. w (T, CAP) bootstrap weights; xs (CAP, d);
    cands (d, Q). Returns feat (T, D), thresh (T, D), leaf (T, CAP)."""
    d, q = cands.shape
    n_trees, cap = w.shape
    # candidate c = f * Q + qi, feature-major as in the reference
    go = (xs.T[:, None, :] > cands[:, :, None]).reshape(d * q, cap)
    wy = w * ys
    wy2 = wy * ys
    leaf = torch.zeros((n_trees, cap), dtype=torch.int64, device=xs.device)
    feats, threshs = [], []
    for level in range(depth):
        seg = leaf[:, None, :] * 2 + go[None, :, :].to(torch.int64)
        sw, swy, swy2 = _segment_sums(seg, 2 ** (level + 1),
                                      w[:, None, :], wy[:, None, :],
                                      wy2[:, None, :])
        sse = (swy2 - swy * swy / sw.clamp_min(_EPS)).sum(-1)  # (T, C)
        best = sse.argmin(-1)                     # first minimum, (T,)
        bf = best // q
        bt = cands.reshape(-1)[best]
        feats.append(bf)
        threshs.append(bt)
        leaf = leaf * 2 + (xs.T[bf] > bt[:, None]).to(torch.int64)
    return torch.stack(feats, 1), torch.stack(threshs, 1), leaf


def fit(xs, ys, mask, key, cfg: SizeyConfig) -> ForestState:
    t, depth = cfg.forest_trees, cfg.forest_depth
    cands = torch.nan_to_num(_candidate_thresholds(xs, mask), nan=0.0)
    n = mask.sum().clamp_min(1.0)
    gmean = (ys * mask).sum() / n
    # Poisson(1) bootstrap weights per tree, drawn on the host and uploaded
    # once (masked-out rows weigh 0)
    boot = torch.from_numpy(
        prng.poisson(key, 1.0, (t, xs.shape[0])).astype(np.float32))
    w = boot.to(xs.device) * mask[None, :]
    feat, thresh, leaf = _grow(w, xs, ys, cands, depth)
    vals = _leaf_means(leaf, w, ys[None, :], 2 ** depth, gmean)
    return ForestState(feat, thresh, vals, gmean)


def _leaf_index(feat, thresh, xq):
    """Leaf of every (query, tree): xq (K, d) -> (K, T)."""
    depth = feat.shape[1]
    bits = (xq[:, feat] > thresh[None]).to(torch.int64)    # (K, T, D)
    weights = 2 ** torch.arange(depth - 1, -1, -1, device=xq.device)
    return (bits * weights).sum(-1)


def update(state: ForestState, xs, ys, mask, new_idx: int, key,
           cfg: SizeyConfig) -> ForestState:
    """Structure-frozen leaf refresh from the full (unweighted) buffer."""
    depth = state.feat.shape[1]
    n = mask.sum().clamp_min(1.0)
    gmean = (ys * mask).sum() / n
    leaf = _leaf_index(state.feat, state.thresh, xs).T        # (T, CAP)
    vals = _leaf_means(leaf, mask[None, :], ys[None, :], 2 ** depth, gmean)
    return ForestState(state.feat, state.thresh, vals, gmean)


def predict_batch(state: ForestState, xq: torch.Tensor) -> torch.Tensor:
    """(K, d) -> (K,): the mean over trees of each query's leaf value."""
    leaf = _leaf_index(state.feat, state.thresh, xq)          # (K, T)
    return state.leaf_vals.gather(1, leaf.T).mean(0)
