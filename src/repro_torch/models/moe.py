"""Top-k routed Mixture-of-Experts (grok-1, phi3.5-moe).

The reference's (``repro/models/moe.py``) on tensors. Dispatch is
capacity-based: tokens are scattered into an (E, C, d) buffer, or a
(B, E, C_row, d) one under the default ``grouped`` dispatch, with their
position in the expert from a one-hot cumsum; overflowing tokens are
dropped (their combine weight is zero), as in Switch. All three
``cfg.moe_dispatch`` modes are kept: ``flat`` (one global cumsum),
``rowwise`` (a per-row cumsum plus row offsets, the same dispatch) and
``grouped`` (capacity per sequence row).

Top-k: ``jax.lax.top_k`` picks the lowest index among equal values first;
``torch.topk`` promises no order among ties, so the top k are taken from
a stable descending sort, which keeps equal values in index order.

The scatter into the capacity buffer is ``index_put`` with
``accumulate=True``, as the reference's ``.at[...].add``: a dropped token
adds a zero row at slot ``cap - 1``, and every kept slot receives exactly
one nonzero row, so the sum does not depend on the order the card adds
in. The expert products are plain products (``torch.einsum``), as the
reference leaves them to XLA outside any kernel; TF32 is off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import shard
from repro_torch.models.layers import INIT_STD, as_type, dense_init
from repro_torch.utils.misc import ceil_div


def moe_params(gen, cfg: ModelConfig, dtype, n: tuple = ()):
    """Router (fp32) and expert SwiGLU weights, with a leading stack of
    shape ``n``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "w_router": dense_init(gen, (*n, d, e), torch.float32),
        "we_gate": dense_init(gen, (*n, e, d, f), dtype),
        "we_up": dense_init(gen, (*n, e, d, f), dtype),
        "we_out": dense_init(gen, (*n, e, f, d), dtype,
                             std=INIT_STD / (2 * max(cfg.n_layers, 1)) ** 0.5),
    }


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lowest
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router(params, x, cfg: ModelConfig, seq: bool = False):
    """x: (T, d) -> top-k (idx (T,k), weights (T,k) fp32, aux loss).

    With ``seq`` (``cfg.seq_shard``) ``x`` is the gathered sequence and
    the block's output is summed over "model" only after the combine, so
    the gradients reaching the router are each rank's part: ``w_router``'s
    is summed over "model", and the load-balance loss, which every rank
    computes alike, passes its gradient on rank 0 alone
    (``tp.use_once``)."""
    w = tp.copy_to_tp(params["w_router"]) if seq else params["w_router"]
    logits = x.float() @ w
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, cfg.top_k)
    top_w = top_w / torch.clamp_min(torch.sum(top_w, -1, keepdim=True), 1e-9)
    # Switch-style load-balance auxiliary loss, over the whole batch (its
    # FSDP shards' means averaged under the sharded step)
    e = cfg.n_experts
    me = tp.batch_mean(torch.mean(F.one_hot(top_i[:, 0], e).float(),
                                  dim=0))                       # routed
    pe = tp.batch_mean(torch.mean(probs, dim=0))                # router mass
    aux = e * torch.sum(me * pe)
    return top_i, top_w, tp.use_once(aux) if seq else aux


def _positions_flat(flat_e, e):
    """Global exclusive cumsum over the flattened (token, slot) dim."""
    onehot = F.one_hot(flat_e, e).to(torch.int32)            # (TK, E)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    return torch.gather(pos, 1, flat_e[:, None])[:, 0]


def _positions_rowwise(top_i, b, s, e, k):
    """Per-sequence cumsum plus a (B, E) row-offset scan: the same
    positions as ``_positions_flat``."""
    rows = top_i.reshape(b, s * k)
    onehot = F.one_hot(rows, e).to(torch.int32)              # (B, S*k, E)
    pos_in_row = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    row_counts = torch.sum(onehot, dim=1, dtype=torch.int32)  # (B, E)
    row_offsets = torch.cumsum(row_counts, dim=0,
                               dtype=torch.int32) - row_counts
    pos = pos_in_row + row_offsets[:, None, :]
    return torch.gather(pos.reshape(b * s * k, e), 1,
                        rows.reshape(-1)[:, None])[:, 0]


def _experts(params, buf, cd, spec: str, logical: tuple, seq: bool):
    """Expert SwiGLU over a capacity buffer (``spec`` names its leading
    dims: "e" or "be"; ``logical`` the hidden's logical axes, ff sharded
    over "model"). Under TP ``we_gate``/``we_up`` are the rank's ``ff``
    columns and ``we_out`` its rows, the buffer built from
    ``tp.copy_to_tp`` of the tokens; the experts' sum over "model", or,
    with ``seq``, the rank's partial sum (the block reduce-scatters the
    combined tokens instead: they are fewer than the buffer's rows)."""
    g = F.silu(torch.einsum(f"{spec}cd,edf->{spec}cf", buf,
                            as_type(params["we_gate"], cd)))
    u = torch.einsum(f"{spec}cd,edf->{spec}cf", buf,
                     as_type(params["we_up"], cd))
    h = shard(g * u, logical)
    out = torch.einsum(f"{spec}cf,efd->{spec}cd", h,
                       as_type(params["we_out"], cd))
    return out if seq else tp.reduce_from_tp(out)


def moe_block(params, x, cfg: ModelConfig, seq: bool = False):
    """x: (B, S, d) -> (y, aux_loss). Dispatch mode per cfg.moe_dispatch.
    With ``seq`` (``cfg.seq_shard``) ``x`` and ``y`` are the rank's slice
    of the sequence; the router and dispatch see the gathered sequence."""
    if cfg.moe_dispatch == "grouped":
        return _moe_block_grouped(params, x, cfg, seq)
    xe = tp.copy_to_tp(x, seq)
    b, s, d = xe.shape
    cd = x.dtype
    t = b * s
    top_i, top_w, aux = router(params, (xe if seq else x).reshape(t, d),
                               cfg, seq)

    k = cfg.top_k
    e = cfg.n_experts
    cap = ceil_div(int(cfg.capacity_factor * k * t), e)

    # flatten (token, slot) pairs and compute position-in-expert
    flat_e = top_i.reshape(t * k)                     # (TK,)
    flat_w = top_w.reshape(t * k).to(cd)
    if cfg.moe_dispatch == "rowwise":
        flat_pos = _positions_rowwise(top_i, b, s, e, k)
    else:
        flat_pos = _positions_flat(flat_e, e)
    keep = flat_pos < cap
    flat_w = torch.where(keep, flat_w, torch.zeros_like(flat_w))
    safe_pos = torch.where(keep, flat_pos, torch.full_like(flat_pos, cap - 1))

    # scatter tokens into the (E, C, d) buffer
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e, cap, d), dtype=cd, device=x.device)
    buf = buf.index_put((flat_e, safe_pos.long()),
                        xe.reshape(t, d)[tok_idx] * keep[:, None].to(cd),
                        accumulate=True)
    buf = shard(buf, ("experts", "batch", None))
    out = _experts(params, buf, cd, "e", ("experts", "batch", "ff"), seq)

    # combine: gather each (token, slot) row back, weight, and sum slots
    y = out[flat_e, safe_pos.long()] * flat_w[:, None]
    y = torch.sum(y.reshape(t, k, d), dim=1).reshape(b, s, d)
    return (tp.reduce_from_tp(y, seq=True) if seq else y), aux


def _moe_block_grouped(params, x, cfg: ModelConfig, seq: bool):
    """Grouped dispatch: capacity is per sequence row (the GShard/Switch
    "group" = batch row), so every scatter and gather stays within a row;
    the buffer is (B, E, C_row, d)."""
    xe = tp.copy_to_tp(x, seq)
    b, s, d = xe.shape
    cd = x.dtype
    k, e = cfg.top_k, cfg.n_experts
    # at least k slots per row: single-token decode (s=1) must never drop
    cap = max(ceil_div(int(cfg.capacity_factor * k * s), e), k)

    top_i, top_w, aux = router(params, (xe if seq else x).reshape(b * s, d),
                               cfg, seq)
    rows_e = top_i.reshape(b, s * k)                  # expert per (tok,slot)
    rows_w = top_w.reshape(b, s * k).to(cd)

    onehot = F.one_hot(rows_e, e).to(torch.int32)           # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    row_pos = torch.gather(pos, 2, rows_e[..., None])[..., 0]
    keep = row_pos < cap
    rows_w = torch.where(keep, rows_w, torch.zeros_like(rows_w))
    safe_pos = torch.where(keep, row_pos,
                           torch.full_like(row_pos, cap - 1)).long()

    # row-local scatter into (B, E, C_row, d)
    tok_idx = torch.arange(s, device=x.device).repeat_interleave(k)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, cap, d), dtype=cd, device=x.device)
    buf = buf.index_put((bidx, rows_e, safe_pos),
                        xe[:, tok_idx] * keep[..., None].to(cd),
                        accumulate=True)
    buf = shard(buf, ("batch", "experts", None, None))
    out = _experts(params, buf, cd, "be", ("batch", "experts", None, "ff"),
                   seq)

    y = out[bidx, rows_e, safe_pos] * rows_w[..., None]   # (B, S*k, d)
    y = torch.sum(y.reshape(b, s, k, d), dim=2)
    return (tp.reduce_from_tp(y, seq=True) if seq else y), aux
