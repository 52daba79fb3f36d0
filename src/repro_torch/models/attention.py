"""GQA attention: full (train/prefill) and cached single-token decode.

Projections are stored flattened, (d_model, n_heads * head_dim), as in the
reference (``repro/models/attention.py``); heads are reshaped inside.

``causal_attention`` is the one dispatch point of full attention: it goes
to the flash-attention kernel (K4) through ``kernels.flash_attention``,
the CUDA kernel for tensors on the card and its plain version on the CPU.
The reference switches between a naive softmax and a chunked online
softmax by sequence length (``CHUNKED_THRESHOLD``); both compute the same
function, and here that switch collapses into K4, whose tiles never
materialise the (S, S) scores on the card. K4 keeps the scores in fp32
and masks with -1e30 (the TPU kernel's numerics); the reference's naive
path rounds scores and probabilities to the compute type and masks with
-1e9, so the two agree to fp32 rounding in fp32 and differ by bf16
rounding in bf16.

``decode_attention_block`` goes to the flash-decode kernel (K5) in the
same way. It writes the new K/V at ``pos`` in place (``index_copy_`` with
``pos`` on the device, no host sync; an e4m3 cache through a byte view);
the reference writes them with an elementwise select over the whole cache
(a GSPMD workaround). The values are the same. Under TP it runs K5's
log-sum-exp variant on the rank's slice of the cache and merges the
slices across ranks.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import shard
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  flash_decode_lse)
from repro_torch.models.layers import (INIT_STD, apply_rope, as_type,
                                       dense_init, rope_angles)


def attention_params(gen, cfg: ModelConfig, dtype, n: tuple = ()):
    """Attention weights, with a leading stack of shape ``n``."""
    d = cfg.d_model
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv * cfg.head_dim
    p = {
        "wq": dense_init(gen, (*n, d, qd), dtype),
        "wk": dense_init(gen, (*n, d, kvd), dtype),
        "wv": dense_init(gen, (*n, d, kvd), dtype),
        "wo": dense_init(gen, (*n, qd, d), dtype,
                         std=INIT_STD / (2 * max(cfg.n_layers, 1)) ** 0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = torch.zeros((*n, width), dtype=dtype,
                                  device=gen.device)
    return p


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """x (B, S, d) -> q (B, S, H, D), k and v (B, S, Hkv, D), RoPE applied
    (H and Hkv the weights' own: the rank's heads under TP)."""
    b, s, _ = x.shape
    cd = x.dtype
    q = x @ as_type(params["wq"], cd)
    k = x @ as_type(params["wk"], cd)
    v = x @ as_type(params["wv"], cd)
    if cfg.qkv_bias:
        q = q + as_type(params["bq"], cd)
        k = k + as_type(params["bk"], cd)
        v = v + as_type(params["bv"], cd)
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def causal_attention(q, k, v, cfg: ModelConfig):
    """q (B, S, H, D), k and v (B, S, Hkv, D) -> (B, S, H, D), through K4."""
    return flash_attention(q, k, v, causal=True, scale=cfg.head_dim ** -0.5)


def attention_block(params, x, cfg: ModelConfig, positions):
    """Full self-attention sublayer (the caller adds the residual).
    Returns (out, (k, v)) so that prefill can collect the cache.

    Under TP (``distributed.tp``) ``wq`` is column-parallel over the
    rank's query heads and ``wo`` row-parallel, and K4 runs on those heads
    and the KV heads they use (``tp.attention_shard``). Under
    ``cfg.seq_shard`` ``x`` is the rank's slice of the sequence: gathered
    before the projections, and the output reduce-scattered back onto the
    slice (K/V and ``positions`` are the whole sequence's)."""
    params = tp.attention_shard(params, cfg.n_heads, cfg.n_kv, cfg.head_dim)
    x = tp.copy_to_tp(x, cfg.seq_shard)
    q, k, v = _project_qkv(params, x, cfg, positions)
    q = shard(q, ("batch", None, "heads", None))
    k = shard(k, ("batch", None, "heads", None))
    v = shard(v, ("batch", None, "heads", None))
    o = causal_attention(q, k, v, cfg)
    b, s = x.shape[:2]
    o = o.reshape(b, s, -1)
    return (tp.reduce_from_tp(o @ as_type(params["wo"], x.dtype),
                              cfg.seq_shard), (k, v))


def decode_attention_block(params, x, cfg: ModelConfig, k_cache, v_cache,
                           pos):
    """Single-token decode against one layer's KV cache, through K5.

    x (B, 1, d); k_cache, v_cache (B, S_max, Hkv, D), written at ``pos``
    in place; pos a 0-d int32 tensor on x's device, the number of tokens
    already in the cache. Returns (out, k_cache, v_cache). The cache may
    be e4m3 (``cfg.kv_dtype``): K5 widens it on read, and P is rounded to
    the compute type, as the reference model casts the cache on read and
    rounds its probabilities (``repro/models/attention.py:190-203``).

    Under TP (``distributed.tp``) the cache is this rank's slice of the
    sequence, as ``cache_specs`` lays it out: ``wq`` is column-parallel
    over the rank's query heads and ``wo`` row-parallel; the step's q and
    new K/V are gathered over "model" (every rank holds a slice of every
    KV head); the rank that owns ``pos`` writes the new K/V; K5's
    log-sum-exp variant runs every head over the slice, and the slices
    merge, for the rank's heads, in rank order (``tp.merge_heads``)."""
    b = x.shape[0]
    params = tp.attention_shard(params, cfg.n_heads, cfg.n_kv, cfg.head_dim)
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k_new, v_new = _project_qkv(params, tp.copy_to_tp(x), cfg, positions)
    scale = cfg.head_dim ** -0.5
    if tp.model_size() > 1:
        q = tp.gather_heads(q, cfg.n_heads, cfg.n_kv)
        k_new, v_new = tp.gather_heads(torch.cat([k_new, v_new], 1),
                                       cfg.n_heads, cfg.n_kv,
                                       kv=True).split(1, 1)
    offset = tp.seq_offset(k_cache.shape[1])
    tp.write_at(k_cache, k_new, pos - offset)
    tp.write_at(v_cache, v_new, pos - offset)
    k_cache = shard(k_cache, ("batch", "kv_seq", None, None))
    v_cache = shard(v_cache, ("batch", "kv_seq", None, None))
    # the reference also keeps its (B, H, S) scores sequence-sharded
    # ("batch", None, "kv_seq"); here they live inside K5, which splits
    # them over the cache's sequence already (split-KV)
    if tp.model_size() == 1:
        o = flash_decode(q, k_cache, v_cache, pos, scale=scale,
                         p_dtype=q.dtype)
    else:
        o, lse = flash_decode_lse(q, k_cache, v_cache, pos, offset=offset,
                                  scale=scale, p_dtype=q.dtype)
        o = tp.merge_heads(o, lse, cfg.n_heads, cfg.n_kv).to(q.dtype)
    o = o.reshape(b, 1, -1)
    return (tp.reduce_from_tp(o @ as_type(params["wo"], x.dtype)), k_cache,
            v_cache)
