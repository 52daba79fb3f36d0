"""Plain PyTorch versions of the SSD-scan kernel.

``ssd_scan_plain`` is the chunked algorithm of the reference model's
``repro/models/ssm.py::_ssd_chunked`` (which is also the function of the
TPU kernel ``repro/kernels/ssd_scan/kernel.py``), in the model's layout:
per chunk of Q positions an intra-chunk quadratic term, and a linear scan
of the (P, N) state across chunks. It returns y and the final state, which
seeds decode. A sequence that is not a multiple of Q is padded with dt = 0
rows, which are inert (the TPU wrapper's padding).

``ssd_scan_recurrence`` is the literal O(S) recurrence of the reference
oracle ``repro/kernels/ssd_scan/ref.py``, a second oracle for the tests:

    state_t = exp(dt_t a) state_{t-1} + dt_t (x_t outer B_t)
    y_t     = state_t . C_t
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_scan_plain(x, dt, bmat, cmat, a, *, q_chunk: int = 128,
                   dtype=torch.float32):
    """x (B, S, H, P); dt (B, S, H) fp32, softplused; bmat, cmat (B, S, N);
    a (H,) = -exp(a_log) -> (y (B, S, H, P), state (B, H, P, N)), computed
    in ``dtype`` (fp32, as the kernel; fp64 gives the tests a yardstick
    of fp32's own rounding)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = q_chunk
    pad = -s % q
    xh, dtf, a = x.to(dtype), dt.to(dtype), a.to(dtype)
    bm, cm = bmat.to(dtype), cmat.to(dtype)
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    nc = (s + pad) // q
    xh = xh.reshape(b, nc, q, h, p)
    dtf = dtf.reshape(b, nc, q, h)
    bm = bm.reshape(b, nc, q, n)
    cm = cm.reshape(b, nc, q, n)

    da = dtf * a[None, None, None, :]
    cum = torch.cumsum(da, dim=2)                            # inclusive
    xs = xh * dtf[..., None]

    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.where(mask[None, None, :, :, None], torch.exp(diff),
                        torch.zeros((), device=x.device))
    g = torch.einsum("bcqn,bckn->bcqk", cm, bm)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", g[..., None] * decay, xs)

    w_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bckn,bckhp->bchpn", bm, xs * w_end[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B, nc, H)
    carry = torch.zeros((b, h, p, n), dtype=dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, 1)                              # (B,nc,H,P,N)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cm, prev) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y, carry


def ssd_scan_recurrence(x, dt, bmat, cmat, a, *, dtype=torch.float32):
    """The literal recurrence, one position at a time: same arguments and
    results as :func:`ssd_scan_plain`."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    xf, dtf, a = x.to(dtype), dt.to(dtype), a.to(dtype)
    bm, cm = bmat.to(dtype), cmat.to(dtype)
    state = torch.zeros((b, h, p, n), dtype=dtype, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a[None, :])            # (B, H)
        upd = (xf[:, t] * dtf[:, t, :, None])[..., None] \
            * bm[:, t, None, None, :]
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    return torch.stack(ys, 1), state
