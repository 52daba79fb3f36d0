"""Plain PyTorch versions of the flash-decode kernel.

``flash_decode_plain`` is the function of the reference TPU kernel
(``repro/kernels/flash_decode/kernel.py``), in the model's layout: one
query token against the cache positions ``0..pos``, K read as fp32 whatever
the cache's type, fp32 scores, -1e30 past ``pos``, the softmax's numerator
rounded to ``p_dtype`` before P.V (the TPU kernel's: v's type, the
default; the reference *model* rounds it to the query's type,
``repro/models/attention.py:190-203``, and passes that) and the division
by the fp32 denominator last.

``flash_decode_lse_plain`` is the same over one rank's slice of the cache,
the positions ``offset..offset + S_loc - 1`` of a cache sharded over the
sequence: it returns the fp32 output, normalised but not rounded, and each
row's log-sum-exp, so that the slices merge once, after all of them
(``merge_partials``). A slice with no live position returns o = 0 and
lse = -inf, which the merge weights 0. ``pos`` may be a tensor on the
cache's device: it is compared there, with no copy to the host.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_lse_plain(q, k_cache, v_cache, pos, *, offset: int = 0,
                           scale: float | None = None, p_dtype=None):
    """q (B, 1, H, D); caches (B, S_loc, Hkv, D) holding the positions
    ``offset..offset + S_loc - 1``; pos the last live position (global) ->
    (o (B, 1, H, D) fp32, lse (B, 1, H) fp32)."""
    b, _, h, d = q.shape
    s_loc, hkv = k_cache.shape[1], k_cache.shape[2]
    scale = d ** -0.5 if scale is None else scale
    p_dtype = v_cache.dtype if p_dtype is None else p_dtype
    qg = q.float().reshape(b, hkv, h // hkv, d)              # (B, Hkv, G, D)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    live = torch.arange(offset, offset + s_loc, device=q.device) <= pos
    sc = sc.masked_fill(~live, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.where(live, torch.exp(sc - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(p_dtype).float(),
                     v_cache.float()) / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l), -torch.inf)
    return o.reshape(b, 1, h, d), lse.reshape(b, 1, h)


def flash_decode_plain(q, k_cache, v_cache, pos, *,
                       scale: float | None = None, p_dtype=None):
    """q (B, 1, H, D); caches (B, S_max, Hkv, D); pos the last live
    position (int or 0-d tensor) -> (B, 1, H, D) in q's type."""
    o, _ = flash_decode_lse_plain(q, k_cache, v_cache, pos, scale=scale,
                                  p_dtype=p_dtype)
    return o.to(q.dtype)


def merge_partials(o_parts, lse_parts):
    """The attention over a whole cache from its slices' normalised
    outputs ``o_parts`` (R, ...rows, D) fp32 and log-sum-exps ``lse_parts``
    (R, ...rows), added in slice order (the same order on every rank).
    A slice whose lse is -inf weighs 0; slice 0 holds position 0, so some
    slice of every row is live."""
    top = lse_parts.amax(0)
    num = den = 0.0
    for o, lse in zip(o_parts, lse_parts):
        w = torch.exp(lse - top)
        num = num + w[..., None] * o
        den = den + w
    return num / den[..., None]
