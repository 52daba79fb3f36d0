"""Plain PyTorch version of the flash-attention kernel.

The function of the reference TPU kernel
(``repro/kernels/flash_attention/kernel.py``), in the model's layout: fp32
scores, -1e30 where masked, the softmax's numerator rounded to v's type
before P.V (the TPU kernel's ``p.astype(v.dtype)``) and the division by
the fp32 denominator last. The kernel takes the maximum and the sums tile
by tile (an online softmax), so the two differ by fp32 rounding only; in
bf16 also where a tile's running maximum rounds p otherwise.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None,
                          kv_len: int | None = None):
    """q (B, S, H, D); k, v (B, S, Hkv, D) -> (B, S, H, D) in q's type.
    Keys at positions >= ``kv_len`` are masked."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kv_len = s if kv_len is None else kv_len
    groups = h // hkv
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, S, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(groups, 1)
    vv = v.permute(0, 2, 1, 3).repeat_interleave(groups, 1)
    sc = (qf @ kf.transpose(-1, -2)) * scale                 # (B, H, S, S)
    cols = torch.arange(s, device=q.device)
    mask = (cols < kv_len)[None, :].expand(s, s)
    if causal:
        mask = mask & (cols[:, None] >= cols[None, :])
    sc = sc.masked_fill(~mask, NEG_INF)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = (p.to(v.dtype).float() @ vv.float()) / l.clamp_min(1e-30)
    return o.to(q.dtype).permute(0, 2, 1, 3)


def flash_attention_backward_plain(q, k, v, dout, *, causal: bool = True,
                                   scale: float | None = None,
                                   kv_len: int | None = None):
    """The plain backward, (dq, dk, dv): ``torch.autograd.grad`` of
    ``flash_attention_plain`` on the same inputs, on any device. The
    tests and ``chip_smoke.py`` hold K4's backward to it; nothing on the
    training path calls it."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, scale=scale,
                                    kv_len=kv_len)
        return torch.autograd.grad(out, leaves, dout)


def flash_attention_backward_rounded(q, k, v, dout, *, causal: bool = True,
                                     scale: float | None = None,
                                     kv_len: int | None = None):
    """The backward as K4's backward kernel computes it, (dq, dk, dv), in
    one pass over the (S, S) matrices: p = exp(s * scale - lse) from each
    row's log-sum-exp, Delta = rowsum(dO * O) from the forward's output
    in q's type, dV = p^T dO with p rounded to v's type, dS = p (dO V^T -
    Delta) rounded to q's type (the kernel's A operand of dS K and dS^T
    Q; the plain backward keeps dS in fp32), dQ = dS K * scale and dK =
    dS^T Q * scale, each head's share of dK and dV summed over its group.
    The tests hold it to ``flash_attention_backward_plain``; nothing on
    the training path calls it."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kv_len = s if kv_len is None else kv_len
    groups = h // hkv
    out = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                kv_len=kv_len)
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, S, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(groups, 1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(groups, 1)
    do = dout.float().permute(0, 2, 1, 3)
    sc = (qf @ kf.transpose(-1, -2)) * scale
    cols = torch.arange(s, device=q.device)
    mask = (cols < kv_len)[None, :].expand(s, s)
    if causal:
        mask = mask & (cols[:, None] >= cols[None, :])
    sc = sc.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(sc, -1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - lse), torch.zeros((), device=q.device))
    delta = (do * out.float().permute(0, 2, 1, 3)).sum(-1, keepdim=True)
    dv = p.to(v.dtype).float().transpose(-1, -2) @ do
    ds = (p * (do @ vf.transpose(-1, -2) - delta)).to(q.dtype).float()
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale

    def per_kv_head(t):     # (B, H, S, D) -> (B, S, Hkv, D), group summed
        return t.reshape(b, hkv, groups, s, d).sum(2).permute(0, 2, 1, 3)
    return (dq.permute(0, 2, 1, 3).to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))
