"""Plain versions of the segment-boundary DP: a numpy copy of the
reference's bitwise oracle and a plain PyTorch version that repeats it.

``cost_matrix_ref`` and ``fit_cuts_ref`` are the reference's
``repro.kernels.segment_dp.ref`` as it is: every rounding in a fixed
order, so that the fitted cut INDICES (picked by argmin) are the same on
any input. The recipe:

  * float32 throughout;
  * ``cost(i, j) = sum_m (rmax[m]·(j-i) - csum[m])`` over grid columns
    [i, j): ``rmax`` an exact running max, ``csum`` a running sum from
    column i left to right, and each value one multiply and one subtract,
    each rounded;
  * the sum over profiles m a left fold in index order, from 0.0;
  * the DP a first-index argmin over whole columns.

``cost_matrix_plain`` and ``fit_cuts_plain`` are the same function in
PyTorch, on any device: ``torch.sum`` and ``torch.cumsum`` do not promise
an order, so the column sum and the fold over m are loops of eager adds.
The CUDA kernel (``kernel.cu``) is bitwise equal to them.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["cost_matrix_ref", "fit_cuts_ref", "cost_matrix_plain",
           "fit_cuts_plain"]


def cost_matrix_ref(profiles: np.ndarray) -> np.ndarray:
    """(M, G) float32 profiles -> (G+1, G+1) float32 cost, ``inf`` where
    ``j <= i``; ``cost[i, j]`` is the over-reservation of covering grid
    columns [i, j) by one segment allocated at the segment max."""
    P = np.asarray(profiles, np.float32)
    m, g = P.shape
    cost = np.full((g + 1, g + 1), np.inf, np.float32)
    widths = np.arange(1, g + 1, dtype=np.float32)      # exact small ints
    for i in range(g):
        tail = P[:, i:]
        rmax = np.maximum.accumulate(tail, axis=1)      # exact, order-free
        csum = np.cumsum(tail, axis=1, dtype=np.float32)   # sequential
        val = rmax * widths[None, :g - i] - csum        # (M, g-i)
        colsum = np.zeros(g - i, np.float32)
        for row in val:                                 # left fold over m
            colsum += row
        cost[i, i + 1:] = colsum
    return cost


def fit_cuts_ref(profiles: np.ndarray, k: int) -> np.ndarray:
    """Boundary DP on the reference cost matrix: the k cut columns (ends,
    last == G) minimizing total over-reservation. ``k`` must already be
    clamped to [1, G]."""
    P = np.asarray(profiles, np.float32)
    g = P.shape[1]
    cost = cost_matrix_ref(P)
    dp = np.full((k + 1, g + 1), np.inf, np.float32)
    back = np.zeros((k + 1, g + 1), np.int64)
    dp[0, 0] = 0.0
    for s in range(1, k + 1):
        cand = dp[s - 1][:, None] + cost                # (g+1, g+1)
        back[s] = np.argmin(cand, axis=0)               # first index
        dp[s] = cand[back[s], np.arange(g + 1)]
    cuts = np.empty(k, np.int64)
    j = g
    for s in range(k, 0, -1):
        cuts[s - 1] = j
        j = int(back[s, j])
    return cuts


def cost_matrix_plain(P: torch.Tensor) -> torch.Tensor:
    """(M, G) float32 -> (G+1, G+1) float32 cost, ``inf`` where ``j <= i``,
    on ``P``'s device; bitwise :func:`cost_matrix_ref`. All start columns
    i at once: entry [i, m, g] is the segment [i, g] of profile m."""
    m, g = P.shape
    dev = P.device
    idx = torch.arange(g, device=dev)
    started = idx[:, None, None] <= idx[None, None, :]        # (G_i, 1, G)
    neg = torch.full((), -torch.inf, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rmax = torch.where(started, torch.cummax(
        torch.where(started, P[None], neg), dim=2).values, zero)
    csum = torch.zeros((g, m, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((g, m), dtype=torch.float32, device=dev)
    for col in range(g):                       # running sum, left to right
        acc = acc + torch.where(started[:, :, col], P[None, :, col], zero)
        csum[:, :, col] = acc
    widths = (idx[None, None, :] - idx[:, None, None] + 1).to(torch.float32)
    val = torch.where(started, rmax * widths - csum, zero)    # 2 roundings
    colsum = torch.zeros((g, g), dtype=torch.float32, device=dev)
    for row in range(m):                       # left fold over profiles
        colsum = colsum + val[:, row, :]
    cost = torch.full((g + 1, g + 1), torch.inf, dtype=torch.float32,
                      device=dev)
    cost[:g, 1:] = torch.where(started[:, 0, :], colsum,
                               torch.full_like(colsum, torch.inf))
    return cost


def fit_cuts_plain(P: torch.Tensor, k: int) -> torch.Tensor:
    """The k cut columns (int64, ends, last == G) on ``P``'s device;
    bitwise :func:`fit_cuts_ref`."""
    g = P.shape[1]
    cost = cost_matrix_plain(P)
    cols = torch.arange(g + 1, device=P.device)
    dp = torch.full((g + 1,), torch.inf, dtype=torch.float32,
                    device=P.device)
    dp[0] = 0.0
    back = []
    for _ in range(k):
        cand = dp[:, None] + cost
        b = torch.argmin(cand, dim=0)                  # first index
        dp = cand[b, cols]
        back.append(b)
    cuts = torch.empty(k, dtype=torch.int64, device=P.device)
    j = torch.full((), g, dtype=torch.int64, device=P.device)
    for s in range(k - 1, -1, -1):
        cuts[s] = j
        j = back[s][j]
    return cuts
