"""MLP regression trained with full-batch Adam.

One hidden tanh layer models non-linear memory ~ input relationships
(paper Fig. 5). A full retrain re-initialises the weights from the fit's
key (:func:`repro_torch.core.prng.normal`, equal to the reference's
``jax.random.normal``) and runs ``mlp_train_steps`` Adam steps; with HPO
the learning rates of ``HPO_LRS`` train side by side as one batch
dimension and the lowest final loss wins. The incremental update runs
``mlp_incremental_steps`` steps from the current weights.

Training is plain torch with the gradients written out, in the order the
reference's autodiff takes them (the tanh derivative as
``(g + g*h) * (1 - h)``). ``predict_batch`` is one launch of the fused
MLP-predict kernel (:mod:`repro_torch.kernels.ensemble_mlp`), normalisation
and de-normalisation included.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.config import SizeyConfig
from repro_torch.kernels.ensemble_mlp.ops import mlp_predict
from repro_torch.utils.misc import device_constant

_EPS = 1e-6
HPO_LRS = (0.03, 0.01, 0.003)
_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


class MLPState(NamedTuple):
    w1: torch.Tensor   # (d, h)
    b1: torch.Tensor   # (h,)
    w2: torch.Tensor   # (h, 1)
    b2: torch.Tensor   # (1,)
    m: tuple           # Adam first moments (w1, b1, w2, b2)
    v: tuple           # Adam second moments
    step: torch.Tensor
    mu_x: torch.Tensor
    sd_x: torch.Tensor
    mu_y: torch.Tensor
    sd_y: torch.Tensor
    lr: torch.Tensor   # winning learning rate from HPO


def _shapes(d: int, h: int):
    return ((d, h), (h,), (h, 1), (1,))


def _unflatten(flat: torch.Tensor, d: int, h: int) -> tuple:
    """Views of one (..., P) parameter vector as (w1, b1, w2, b2)."""
    out, i = [], 0
    for s in _shapes(d, h):
        n = int(np.prod(s))
        out.append(flat[..., i:i + n].reshape(*flat.shape[:-1], *s))
        i += n
    return tuple(out)


def _flatten(params) -> torch.Tensor:
    lead = params[0].shape[:-2]
    return torch.cat([p.reshape(*lead, -1) for p in params], -1)


def _norm_stats(xs, ys, mask):
    n = mask.sum().clamp_min(1.0)
    mu_x = (xs * mask[:, None]).sum(0) / n
    sd_x = ((((xs - mu_x) ** 2) * mask[:, None]).sum(0) / n).sqrt() + _EPS
    mu_y = (ys * mask).sum() / n
    sd_y = ((((ys - mu_y) ** 2) * mask).sum() / n).sqrt() + _EPS
    return mu_x, sd_x, mu_y, sd_y


def init_params(key, d: int, h: int) -> np.ndarray:
    """The reference's ``_init_params``: W1 ~ N(0,1)/sqrt(d), W2 ~
    N(0,1)/sqrt(h), zero biases; returned flat (P,) float32 on the host."""
    k1, k2 = prng.split(key)
    f32 = np.float32
    s1 = f32(1.0) / np.sqrt(f32(d))
    s2 = f32(1.0) / np.sqrt(f32(h))
    return np.concatenate([
        (prng.normal(k1, (d, h)) * s1).ravel(), np.zeros(h, f32),
        (prng.normal(k2, (h, 1)) * s2).ravel(), np.zeros(1, f32)])


def _forward(w1, b1, w2, b2, xn):
    """Batched forward: params with a leading (L,) axis, xn (CAP, d) ->
    hidden (L, CAP, h) and predictions (L, CAP)."""
    hid = torch.tanh(torch.matmul(xn, w1) + b1[:, None, :])
    return hid, torch.matmul(hid, w2)[..., 0] + b2


def _loss(flat, xn, yn, mask, n, d, h):
    _hid, pred = _forward(*_unflatten(flat, d, h), xn)
    return (((pred - yn) ** 2) * mask).sum(-1) / n


def _grads(flat, xn, yn, g_coef, d, h):
    """d loss / d params for every batch row, (L, P). ``g_coef`` is
    mask / n, the cotangent of the squared residuals."""
    w1, b1, w2, b2 = _unflatten(flat, d, h)
    hid, pred = _forward(w1, b1, w2, b2, xn)
    g_r = g_coef * (2.0 * (pred - yn))                       # (L, CAP)
    g_w2 = torch.matmul(hid.transpose(1, 2), g_r[..., None])  # (L, h, 1)
    g_hid = g_r[..., None] * w2.transpose(1, 2)              # (L, CAP, h)
    g_pre = (g_hid + g_hid * hid) * (1.0 - hid)
    g_w1 = torch.matmul(xn.T, g_pre)                         # (L, d, h)
    return torch.cat([g_w1.flatten(1), g_pre.sum(1), g_w2.flatten(1),
                      g_r.sum(-1, keepdim=True)], -1)


def _adam_steps(flat, m, v, step, xn, yn, mask, lr, n_steps, d, h):
    """``n_steps`` of full-batch Adam on (L, P) parameter rows, each row
    with its own learning rate ``lr`` (L, 1)."""
    n = mask.sum().clamp_min(1.0)
    g_coef = mask / n
    for _ in range(n_steps):
        g = _grads(flat, xn, yn, g_coef, d, h)
        step = step + 1
        m = _B1 * m + (1 - _B1) * g
        v = _B2 * v + (1 - _B2) * g * g
        mhat = m / (1 - _B1 ** step)
        vhat = v / (1 - _B2 ** step)
        flat = flat - lr * mhat / (vhat.sqrt() + _ADAM_EPS)
    return flat, m, v, step


def _state(flat, m, v, step, stats, lr, d, h) -> MLPState:
    return MLPState(*_unflatten(flat, d, h), _unflatten(m, d, h),
                    _unflatten(v, d, h), step, *stats, lr)


def fit(xs, ys, mask, key, cfg: SizeyConfig) -> MLPState:
    d, h = xs.shape[-1], cfg.mlp_hidden
    stats = _norm_stats(xs, ys, mask)
    mu_x, sd_x, mu_y, sd_y = stats
    xn = (xs - mu_x) / sd_x
    yn = (ys - mu_y) / sd_y
    lrs = device_constant(HPO_LRS if cfg.hpo else (0.01,), xs.device)
    flat0 = torch.from_numpy(init_params(key, d, h)).to(xs.device)
    flat0 = flat0.expand(len(lrs), -1)
    zeros = torch.zeros_like(flat0)
    step0 = torch.zeros((), dtype=torch.float32, device=xs.device)
    flat, m, v, step = _adam_steps(flat0, zeros, zeros, step0, xn, yn, mask,
                                   lrs[:, None], cfg.mlp_train_steps, d, h)
    n = mask.sum().clamp_min(1.0)
    best = _loss(flat, xn, yn, mask, n, d, h).argmin().reshape(1)
    take = lambda a: a.index_select(0, best)[0]
    return _state(take(flat), take(m), take(v), step, stats, take(lrs),
                  d, h)


def update(state: MLPState, xs, ys, mask, new_idx: int, key,
           cfg: SizeyConfig) -> MLPState:
    d, h = xs.shape[-1], cfg.mlp_hidden
    stats = _norm_stats(xs, ys, mask)
    mu_x, sd_x, mu_y, sd_y = stats
    xn = (xs - mu_x) / sd_x
    yn = (ys - mu_y) / sd_y
    row = lambda params: _flatten(params)[None]
    flat, m, v, step = _adam_steps(
        row((state.w1, state.b1, state.w2, state.b2)), row(state.m),
        row(state.v), state.step, xn, yn, mask, state.lr.reshape(1, 1),
        cfg.mlp_incremental_steps, d, h)
    return _state(flat[0], m[0], v[0], step, stats, state.lr, d, h)


def predict_batch(state: MLPState, xq: torch.Tensor) -> torch.Tensor:
    """(K, d) -> (K,) in one launch of the fused MLP-predict kernel."""
    return mlp_predict(xq.contiguous(), state.w1, state.b1, state.w2,
                       state.b2, state.mu_x, state.sd_x, state.mu_y,
                       state.sd_y)
