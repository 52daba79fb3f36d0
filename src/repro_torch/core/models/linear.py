"""Ridge linear regression via incremental sufficient statistics.

X'X and X'y are kept in GB units and the (d+1)x(d+1) normal equations are
solved by Cholesky. ``cholesky_ex`` and two triangular solves keep the
solve free of error checks that would read the device from the host. The
ridge term keeps the system positive definite in exact arithmetic, but
not always in fp32: where every sample of a pool has the same features,
X'X is rank one and its entries' rounding can exceed the ridge, and the
factorization breaks down. The weights are then NaN, as the reference's
``jnp.linalg.cholesky`` makes them (its factor is all NaN where LAPACK
reports a breakdown), and not the partial factor ``cholesky_ex`` leaves.
The online update is a rank-1 accumulation and a re-solve.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.config import SizeyConfig


class LinearState(NamedTuple):
    xtx: torch.Tensor  # (d+1, d+1) sufficient statistic
    xty: torch.Tensor  # (d+1,)
    w: torch.Tensor    # (d+1,) solved ridge weights (bias last)


def _aug(xs: torch.Tensor) -> torch.Tensor:
    """Append the bias column."""
    return torch.cat([xs, torch.ones_like(xs[..., :1])], -1)


def _solve(xtx: torch.Tensor, xty: torch.Tensor, lam: float) -> torch.Tensor:
    a = xtx + lam * torch.eye(xtx.shape[0], dtype=xtx.dtype,
                              device=xtx.device)
    l, info = torch.linalg.cholesky_ex(a)
    # a breakdown makes the whole factor NaN, as in the reference; the
    # check stays on the device
    l = torch.where(info == 0, l, float("nan"))
    z = torch.linalg.solve_triangular(l, xty[:, None], upper=False)
    return torch.linalg.solve_triangular(l.T, z, upper=True)[:, 0]


def fit(xs, ys, mask, key, cfg: SizeyConfig) -> LinearState:
    xa = _aug(xs) * mask[:, None]
    xtx = xa.T @ xa
    xty = xa.T @ (ys * mask)
    return LinearState(xtx, xty, _solve(xtx, xty, cfg.ridge_lambda))


def update(state: LinearState, xs, ys, mask, new_idx: int, key,
           cfg: SizeyConfig) -> LinearState:
    """Rank-1 update with the newest sample (buffer slot ``new_idx``)."""
    x = _aug(xs[new_idx])
    xtx = state.xtx + torch.outer(x, x)
    xty = state.xty + x * ys[new_idx]
    return LinearState(xtx, xty, _solve(xtx, xty, cfg.ridge_lambda))


def predict_batch(state: LinearState, xq: torch.Tensor) -> torch.Tensor:
    """(K, d) -> (K,)."""
    return _aug(xq) @ state.w
