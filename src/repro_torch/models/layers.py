"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, init helpers.

Parameters are plain tensors in nested dicts that mirror the reference's
pytrees (``repro/models/layers.py``), so that ``repro_torch.convert``
carries them across field by field. Each matmul casts its weight to the
compute type as the reference does (``x @ W.astype(cd)``); the cast is a
no-op for a weight already held in that type (see
``models.model.cast_weights``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import shard

INIT_STD = 0.02

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(gen: torch.Generator, shape, dtype, std: float = INIT_STD):
    """Normal(0, std) weights drawn from ``gen`` on its device: in fp32,
    or in bf16 itself for bf16 weights, so that a model held in bf16 at
    full width never holds an fp32 copy of a stacked leaf (13.4 GB more
    for one of phi3.5-moe's 16-layer expert stacks)."""
    if dtype == torch.bfloat16:
        w = torch.empty(shape, dtype=dtype, device=gen.device)
        return w.normal_(0.0, std, generator=gen)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.normal_(0.0, 1.0, generator=gen).mul_(std).to(dtype)


def as_type(w: torch.Tensor, dtype) -> torch.Tensor:
    """``w`` in ``dtype``: the reference's per-matmul ``astype``."""
    return w if w.dtype == dtype else w.to(dtype)


# ----------------------------------------------------------------- RMSNorm
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """fp32-accumulated RMS norm, output in x's type."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> (cos, sin) of shape (..., head_dim / 2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, H, D); cos, sin (..., S, D/2). Rotates in fp32 and casts
    back to x's type."""
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- SwiGLU MLP
def mlp_params(gen, cfg: ModelConfig, dtype, n: tuple = ()):
    """SwiGLU weights, with a leading stack of shape ``n`` (per layer)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (*n, d, f), dtype),
        "w_up": dense_init(gen, (*n, d, f), dtype),
        "w_down": dense_init(gen, (*n, f, d), dtype,
                             std=INIT_STD / (2 * max(cfg.n_layers, 1)) ** 0.5),
    }


def mlp(params, x: torch.Tensor, compute_dtype, seq: bool = False):
    """SwiGLU; under TP ``w_gate``/``w_up`` are the rank's ``ff`` columns
    and ``w_down`` its rows (column- then row-parallel). With ``seq``
    (``cfg.seq_shard``) ``x`` and the output are the rank's slice of the
    sequence (``tp.copy_to_tp``, ``tp.reduce_from_tp``)."""
    x = tp.copy_to_tp(x, seq)
    h = F.silu(x @ as_type(params["w_gate"], compute_dtype)) \
        * (x @ as_type(params["w_up"], compute_dtype))
    h = shard(h, ("batch", None, "ff"))
    return tp.reduce_from_tp(h @ as_type(params["w_down"], compute_dtype),
                             seq)


# -------------------------------------------------------------- embeddings
def embedding_params(gen, cfg: ModelConfig, dtype):
    return {
        "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype),
    }


def embed_tokens(params, tokens: torch.Tensor, compute_dtype,
                 prefix: torch.Tensor | None = None, seq: bool = False):
    """The tokens' rows of ``embed`` (vocab-parallel under TP), after
    ``prefix`` (B, P, d) along the sequence where given; with ``seq``
    (``cfg.seq_shard``) the rank's slice of that sequence
    (``tp.embed_lookup``)."""
    return tp.embed_lookup(as_type(params["embed"], compute_dtype), tokens,
                           prefix, seq)


def logits_fn(params, x: torch.Tensor, cfg: ModelConfig, seq: bool = False):
    """Final logits in fp32 with the padded-vocab tail set to -1e9; under
    TP the rank's vocab columns (B, S, V / model). With ``seq`` ``x`` is
    the rank's slice of the sequence, gathered before ``lm_head``."""
    logits = (tp.copy_to_tp(x, seq)
              @ as_type(params["lm_head"], x.dtype)).float()
    logits = shard(logits, ("batch", None, "vocab"))
    tail = cfg.vocab - tp.vocab_offset(logits.shape[-1])
    if cfg.padded_vocab != cfg.vocab and tail < logits.shape[-1]:
        logits[..., max(tail, 0):] = -1e9
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None):
    """Mean CE over valid positions; logits fp32 (B, S, V), labels (B, S).
    Under TP the logits are the rank's vocab columns
    (``tp.vocab_cross_entropy``)."""
    if tp.model_size() > 1:
        return tp.vocab_cross_entropy(logits, labels, mask)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return -torch.mean(ll)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return -torch.sum(ll * mask) / denom
