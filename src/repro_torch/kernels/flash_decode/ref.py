"""Plain PyTorch version of the flash-decode kernel.

The function of the reference TPU kernel
(``repro/kernels/flash_decode/kernel.py``), in the model's layout: one
query token against the cache positions ``0..pos``, fp32 scores, -1e30
past ``pos``, the softmax's numerator rounded to v's type before P.V and
the division by the fp32 denominator last. ``pos`` may be a tensor on the
cache's device: it is compared there, with no copy to the host.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_plain(q, k_cache, v_cache, pos, *,
                       scale: float | None = None):
    """q (B, 1, H, D); caches (B, S_max, Hkv, D); pos the last live
    position (int or 0-d tensor) -> (B, 1, H, D) in q's type."""
    b, _, h, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, hkv, h // hkv, d)              # (B, Hkv, G, D)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    live = torch.arange(s_max, device=q.device) <= pos
    sc = sc.masked_fill(~live, NEG_INF)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float()) / l.clamp_min(1e-30)
    return o.reshape(b, 1, h, d).to(q.dtype)
