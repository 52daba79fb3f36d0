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


def ssd_scan_backward_plain(x, dt, bmat, cmat, a, dy, dfinal=None, *,
                            q_chunk: int = 128, dtype=torch.float32):
    """The VJP of :func:`ssd_scan_plain` in its chunked form (the state
    passing, chunk state and chunk scan of mamba_ssm's ``ssd_combined``
    backward): dy (B, S, H, P) is the gradient of y and ``dfinal`` (B, H,
    P, N) that of the final state (None: zero) -> (dx, ddt, dB, dC, da),
    shaped as x, dt, bmat, cmat and a, computed in ``dtype``.

    Per chunk, with L[t][k] = exp(cum_t - cum_k) for k <= t (else 0),
    G = C B^T, D[t][k] = dy_t . xs_k, w_k = exp(cum_end - cum_k) and dS the
    gradient of the state leaving the chunk (carried backwards from
    ``dfinal``: dS_{c-1} = exp(cum_end_c) dS_c + sum_t exp(cum_t) dy_t C_t^T):
        dC_t = sum_k D L B_k + exp(cum_t) dy_t^T prev
        dB_k = sum_t D L C_t + w_k dS^T xs_k
        dxs_k = sum_t G L dy_t + w_k dS B_k,    dx = dxs dt
    and dcum collects every exponential's term (the chunk decay's
    exp(cum_end) <dS, prev> on the chunk's last row); dda is the reverse
    cumulative sum of dcum, ddt = dda a + dxs . x and da = sum dda dt."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = q_chunk
    pad = -s % q
    xh, dtf, a = x.to(dtype), dt.to(dtype), a.to(dtype)
    bm, cm, dyh = bmat.to(dtype), cmat.to(dtype), dy.to(dtype)
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dyh = F.pad(dyh, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    nc = (s + pad) // q
    xh = xh.reshape(b, nc, q, h, p)
    dyh = dyh.reshape(b, nc, q, h, p)
    dtf = dtf.reshape(b, nc, q, h)
    bm = bm.reshape(b, nc, q, n)
    cm = cm.reshape(b, nc, q, n)

    cum = torch.cumsum(dtf * a[None, None, None, :], dim=2)
    xs = xh * dtf[..., None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ell = torch.where(mask[None, None, :, :, None], torch.exp(diff),
                      torch.zeros((), dtype=dtype, device=x.device))
    m = torch.einsum("bcqn,bckn->bcqk", cm, bm)[..., None] * ell
    w_end = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,Q,H)
    e_cum = torch.exp(cum)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B, nc, H)

    # the chunk-entry states (forward), then dS (backward over chunks)
    states = torch.einsum("bckn,bckhp->bchpn", bm, xs * w_end[..., None])
    carry = torch.zeros((b, h, p, n), dtype=dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, 1)                              # (B,nc,H,P,N)
    into = torch.einsum("bcqhp,bcqn->bchpn", dyh * e_cum[..., None], cm)
    dcarry = torch.zeros_like(carry) if dfinal is None else dfinal.to(dtype)
    d_states = [None] * nc
    for c in reversed(range(nc)):
        d_states[c] = dcarry
        dcarry = dcarry * chunk_decay[:, c, :, None, None] + into[:, c]
    d_states = torch.stack(d_states, 1)                      # (B,nc,H,P,N)

    dd = torch.einsum("bcqhp,bckhp->bcqkh", dyh, xs)         # dy_t . xs_k
    dl = dd * ell
    dc = torch.einsum("bcqkh,bckn->bcqn", dl, bm) \
        + torch.einsum("bcqh,bcqhp,bchpn->bcqn", e_cum, dyh, prev)
    db = torch.einsum("bcqkh,bcqn->bckn", dl, cm) \
        + torch.einsum("bckh,bckhp,bchpn->bckn", w_end, xs, d_states)
    dxs = torch.einsum("bcqkh,bcqhp->bckhp", m, dyh) \
        + w_end[..., None] * torch.einsum("bchpn,bckn->bckhp", d_states, bm)

    t_md = m * dd                                            # (B,nc,Q,Q,H)
    u = w_end * torch.einsum("bckhp,bckn,bchpn->bckh", xs, bm, d_states)
    dcum = t_md.sum(3) - t_md.sum(2) - u + e_cum * torch.einsum(
        "bcqhp,bcqn,bchpn->bcqh", dyh, cm, prev)
    last = u.sum(2) + chunk_decay * torch.einsum("bchpn,bchpn->bch",
                                                 d_states, prev)
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]],
                     2)
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))
    ddt = dda * a + (dxs * xh).sum(-1)
    dx = dxs * dtf[..., None]
    da = (dda * dtf).sum((0, 1, 2))
    return (dx.reshape(b, nc * q, h, p)[:, :s],
            ddt.reshape(b, nc * q, h)[:, :s],
            db.reshape(b, nc * q, n)[:, :s],
            dc.reshape(b, nc * q, n)[:, :s], da)
