"""Model assembly for all 6 families (dense / moe / ssm / hybrid / vlm /
audio): parameter init, forward, loss, prefill and single-token decode.

The reference (``repro/models/model.py``) scans over stacked per-layer
parameters; here the stacks are the same tensors (a leading layer axis on
every leaf of ``blocks`` and ``mamba``) and the scans are Python loops over
that axis. Each stacked leaf is split into per-layer views once per call
(``torch.unbind``), so a backward pass writes one gradient per stacked
leaf. The hybrid (zamba2) stack walks groups of (attn_every - 1) Mamba2
layers, each group followed by the one shared attention+MLP block, whose
weights are reused at every application. ``moe`` swaps each block's MLP
for ``models.moe``'s routed experts and adds their load-balance loss;
``vlm`` prepends the batch's ``patch_embeds`` to the token embeddings and
takes its loss on the text positions only.

Kernels: full attention goes to K4 (``kernels.flash_attention``), decode
attention to K5 (``kernels.flash_decode``) and the Mamba2 prefill scan to
K6 (``kernels.ssd_scan``), each the CUDA kernel on the card and its plain
version on the CPU; K4 and K6 run their hand-written backward kernels when
a gradient is asked for.

``cfg.remat``: with a gradient asked for, ``"block"`` (the default) and
``"dots"`` recompute each block in the backward
(``torch.utils.checkpoint``, non-reentrant), ``"none"`` keeps every
activation; the numbers are the same. ``"dots"`` is ``"block"`` here:
the reference's ``"dots"`` keeps the matmul outputs, which changes memory
only (ROADMAP queue 3). ``cfg.decode_carry_cache`` changes no number: the
decode cache is updated in place.

Under the sharded train step (``distributed.tp.sharded``) ``forward``
and ``loss_fn`` run on this rank's shards: each layer gathers its
weights' FSDP dims inside its recompute function (``tp.gather_layer``),
so a layer's gathered weights are dropped after it and gathered again
for its backward (each block is recomputed whatever ``cfg.remat`` says
when there are FSDP ranks to gather from); ``embed``, ``lm_head`` and
``ln_f`` are gathered once. The blocks compute tensor-parallel over
"model", and the logits ``forward`` returns are the rank's vocab
columns. With ``cfg.seq_shard`` (the reference's ``"seq_sp"``
annotations, Megatron's sequence parallelism) the residual stream between
the blocks is each "model" rank's slice of the sequence, in ``forward``
and ``prefill``: the embedding's sum is reduce-scattered onto it, the
norms act on it, each block gathers it where it enters the tensor-parallel
region (inside the recompute function, so only the slice is kept between
layers) and reduce-scatters its output back, and the head gathers it
before ``lm_head``; decode keeps the whole position. Under the sharded
serve steps (``launch.dryrun.serve_step``)
``prefill`` and ``decode_step`` run the same way on the cache's shards,
laid out as the reference's ``cache_specs`` lays them out, and return
whole-vocab logits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import shard
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (cross_entropy, dtype_of, embed_tokens,
                                       embedding_params, logits_fn, mlp,
                                       mlp_params, rmsnorm)
from repro_torch.utils.misc import resolve_device

ATTN_FAMILIES = ("dense", "vlm", "audio", "moe")
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# weights that the reference casts to the compute type at every use
COMPUTE_CAST = frozenset({
    "embed", "lm_head", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate",
    "w_up", "w_down", "in_proj", "conv_w", "conv_b", "out_proj", "we_gate",
    "we_up", "we_out"})
AUX_WEIGHT = 0.01


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def _layers(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked parameter tree, as views (one
    ``unbind`` per leaf, so autograd gathers a leaf's layer gradients into
    one tensor)."""
    per = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in tree.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


# ----------------------------------------------------------------- blocks
def _attn_mlp_block_params(gen, cfg: ModelConfig, dtype, n: tuple = (),
                           use_moe: bool = False):
    dev = gen.device
    p = {
        "ln1": torch.ones((*n, cfg.d_model), dtype=dtype, device=dev),
        "attn": attn.attention_params(gen, cfg, dtype, n),
        "ln2": torch.ones((*n, cfg.d_model), dtype=dtype, device=dev),
    }
    if use_moe:
        p["moe"] = moe_mod.moe_params(gen, cfg, dtype, n)
    else:
        p["mlp"] = mlp_params(gen, cfg, dtype, n)
    return p


def _norm(x, scale, cfg: ModelConfig):
    """``rmsnorm`` of the residual stream; under ``cfg.seq_shard`` on the
    rank's slice of the sequence, the scale's gradient summed over
    "model" (each rank's tokens add to it)."""
    return rmsnorm(x, tp.copy_to_tp(scale) if cfg.seq_shard else scale)


def _attn_mlp_block(params, x, cfg: ModelConfig, positions, use_moe: bool):
    """Pre-norm transformer block. Returns (x, (k, v), aux). Under
    ``cfg.seq_shard`` ``x`` is the rank's slice of the sequence, which the
    norms and the residual keep; the attention and the MLP gather it."""
    seq = cfg.seq_shard
    h = _norm(x, params["ln1"], cfg)
    a, kv = attn.attention_block(params["attn"], h, cfg, positions)
    x = x + a
    h = _norm(x, params["ln2"], cfg)
    if use_moe:
        m, aux = moe_mod.moe_block(params["moe"], h, cfg, seq)
    else:
        m, aux = mlp(params["mlp"], h, dtype_of(cfg.compute_dtype), seq), 0.0
    x = shard(x + m, ("batch", "seq_sp" if cfg.seq_shard else None,
                      "embed"))
    return x, kv, aux


def _attn_mlp_decode(params, x, cfg, k_cache, v_cache, pos, use_moe: bool):
    h = rmsnorm(x, params["ln1"])
    a, _, _ = attn.decode_attention_block(params["attn"], h, cfg, k_cache,
                                          v_cache, pos)
    x = x + a
    h = rmsnorm(x, params["ln2"])
    if use_moe:
        m, _ = moe_mod.moe_block(params["moe"], h, cfg)
    else:
        m = mlp(params["mlp"], h, dtype_of(cfg.compute_dtype))
    return x + m


def _ssm_block_params(gen, cfg: ModelConfig, dtype, n: tuple = ()):
    return {
        "ln": torch.ones((*n, cfg.d_model), dtype=dtype, device=gen.device),
        "ssm": ssm_mod.ssm_params(gen, cfg, dtype, n),
    }


def _ssm_block(params, x, cfg: ModelConfig, return_cache: bool = False):
    h = _norm(x, params["ln"], cfg)
    if not return_cache:
        return shard(x + ssm_mod.ssm_block(params["ssm"], h, cfg),
                     ("batch", "seq_sp" if cfg.seq_shard else None,
                      "embed"))
    y, state, conv = ssm_mod.ssm_block(params["ssm"], h, cfg,
                                       return_cache=True)
    return x + y, state, conv


def _ssm_block_decode(params, x, cfg, state, conv):
    h = rmsnorm(x, params["ln"])
    y, state, conv = ssm_mod.ssm_decode_block(params["ssm"], h, cfg, state,
                                              conv)
    return x + y, state, conv


def _layer_order(cfg: ModelConfig):
    """The stack as ("attn", i) and ("ssm", i) steps in depth order; i
    indexes ``blocks``/``mamba`` and the cache's attention or SSM layers
    (the hybrid's shared block is attention layer i of the cache)."""
    if cfg.family in ATTN_FAMILIES:
        return [("attn", i) for i in range(cfg.n_layers)]
    if cfg.family == "ssm":
        return [("ssm", i) for i in range(cfg.n_layers)]
    per = cfg.attn_every - 1
    order = []
    for g in range(cfg.n_attn_layers()):
        order += [("ssm", g * per + i) for i in range(per)]
        order.append(("attn", g))
    return order


def _stack(params, cfg: ModelConfig):
    """Per-layer views of the stacked blocks: (attention layers, SSM
    layers), indexed as ``_layer_order`` indexes them."""
    if cfg.family in ATTN_FAMILIES:
        return _layers(params["blocks"], cfg.n_layers), []
    if cfg.family == "ssm":
        return [], _layers(params["blocks"], cfg.n_layers)
    return ([params["shared"]] * cfg.n_attn_layers(),
            _layers(params["mamba"], cfg.n_ssm_layers()))


def _remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward under ``cfg.remat`` "block" or
    "dots", or when it gathers weights over FSDP ranks, when a gradient is
    being taken; as it is otherwise."""
    if (cfg.remat == "none" and not tp.gathers()) \
            or not torch.is_grad_enabled():
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


# ------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Parameters drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (CUDA unless asked otherwise): normal(0, 0.02) matrices and
    the reference's constant vectors. The draws are the port's own, not
    ``jax.random``'s; ``repro_torch.convert`` carries the reference's
    parameters across where the two must agree."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = dtype_of(cfg.param_dtype)
    params: dict[str, Any] = embedding_params(gen, cfg, dtype)
    params["ln_f"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if cfg.family in ATTN_FAMILIES:
        params["blocks"] = _attn_mlp_block_params(
            gen, cfg, dtype, (cfg.n_layers,), use_moe=cfg.family == "moe")
    elif cfg.family == "ssm":
        params["blocks"] = _ssm_block_params(gen, cfg, dtype,
                                             (cfg.n_layers,))
    else:
        params["mamba"] = _ssm_block_params(gen, cfg, dtype,
                                            (cfg.n_ssm_layers(),))
        params["shared"] = _attn_mlp_block_params(gen, cfg, dtype)
    return params


def cast_weights(params: dict, cfg: ModelConfig) -> dict:
    """The parameter tree with every weight that the reference casts to
    the compute type at each use (``x @ W.astype(cd)``) cast once, the
    others (norm scales, ``a_log``, ``dt_bias``, ``ssm_d``, read in fp32)
    as they are. The cast is deterministic, so every result is bitwise
    that of casting at each use; it holds one more copy of the cast
    weights (9.3 GB for zamba2-7b in bf16) and saves reading the fp32
    weights and writing their casts at every step."""
    cd = dtype_of(cfg.compute_dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else (v.to(cd) if k in COMPUTE_CAST else v)
                for k, v in tree.items()}
    return walk(params)


# ---------------------------------------------------------------- forward
def _inputs_to_h(params, batch, cfg: ModelConfig):
    """Embed tokens (+ prepend stub-frontend patch embeddings for VLM).
    Returns (h, positions (B, S)); under ``cfg.seq_shard`` h is this
    rank's slice of the sequence (refused where S does not split over
    "model"), the positions the whole sequence's."""
    cd = dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"].long()
    prefix = batch["patch_embeds"].to(cd) if cfg.family == "vlm" else None
    b, s = tokens.shape
    s += 0 if prefix is None else prefix.shape[1]
    if cfg.seq_shard:
        tp.check_seq(s)
    h = embed_tokens(params, tokens, cd, prefix, cfg.seq_shard)
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    return shard(h, ("batch", None, "embed")), positions


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward -> (logits fp32 (B, S, V), aux_loss)."""
    _check_family(cfg)
    params = _whole_vocab_params(params)
    h, positions = _inputs_to_h(params, batch, cfg)
    use_moe = cfg.family == "moe"
    attn_layers, ssm_layers = _stack(params, cfg)

    def attn_step(bp, x):
        x, _, a = _attn_mlp_block(tp.gather_layer(bp), x, cfg, positions,
                                  use_moe)
        return x, a

    def ssm_step(bp, x):
        return _ssm_block(tp.gather_layer(bp), x, cfg)
    attn_step = _remat(tp.carried(attn_step), cfg)
    ssm_step = _remat(tp.carried(ssm_step), cfg)
    aux = 0.0
    for kind, i in _layer_order(cfg):
        if kind == "ssm":
            h = ssm_step(ssm_layers[i], h)
        else:
            h, a = attn_step(attn_layers[i], h)
            aux = aux + a
    h = _norm(h, params["ln_f"], cfg)
    return logits_fn(params, h, cfg, cfg.seq_shard), aux


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token CE (+ MoE aux). VLM: loss only on text positions."""
    logits, aux = forward(params, batch, cfg)
    tokens = batch["tokens"]
    b, st = tokens.shape
    if cfg.family == "vlm":
        # patches occupy the first n_patches positions; predict text only
        np_ = cfg.n_patches
        logits = logits[:, np_ - 1: np_ - 1 + st, :]
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((b, st), dtype=torch.float32, device=logits.device)
    mask[:, -1] = 0.0
    ce = cross_entropy(logits, labels, mask)
    return ce + AUX_WEIGHT * aux / max(cfg.n_layers, 1)


# ---------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """KV / SSM decode cache sized for ``max_seq`` positions, with the
    reference's leaves, shapes and types (so ``tree_bytes`` of it is the
    reference's): ``pos`` a 0-d int32, ``k``/``v`` (n_attn, B, max_seq,
    Hkv, D), ``ssm`` {``state`` (n_ssm, B, H, P, N) fp32, ``conv``
    (n_ssm, B, K-1, C)}. Under TP, this rank's shard of each leaf as the
    reference's ``cache_specs`` lays it out: the sequence, the state's
    heads and the tail's channels over "model"."""
    _check_family(cfg)
    dev = resolve_device(device)
    cd = dtype_of(cfg.compute_dtype)
    kvd = cd if cfg.kv_dtype == "compute" else dtype_of(cfg.kv_dtype)
    cache: dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32,
                                                device=dev)}
    if cfg.family in ATTN_FAMILIES + ("hybrid",):
        m = tp.model_size()
        if max_seq % m:
            raise ValueError(f"a cache of {max_seq} positions does not "
                             f"split over {m} 'model' ranks")
        kv = (cfg.n_attn_layers(), batch, max_seq // m, cfg.n_kv,
              cfg.head_dim)
        cache["k"] = torch.zeros(kv, dtype=kvd, device=dev)
        cache["v"] = torch.zeros(kv, dtype=kvd, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = ssm_mod.ssm_cache_init(cfg, batch, cfg.n_ssm_layers(),
                                              cd, dev)
    return cache


def _whole_vocab_params(params):
    """``params`` with the embedding, the head and the final norm gathered
    over the FSDP axes (as ``forward`` takes them)."""
    return {**params, **tp.gather_layer(
        {k: params[k] for k in ("embed", "lm_head", "ln_f")})}


def prefill(params, batch, cfg: ModelConfig, max_seq: int | None = None):
    """Prompt ingestion: the forward plus the decode cache. Returns the
    last position's logits (B, 1, V) and the cache, with ``pos`` = S.

    Under ``tp.sharded`` the blocks run tensor-parallel as ``forward``'s
    do, each layer's weights gathered over the FSDP axes while it runs;
    each attention layer's K/V go from the rank's KV heads to every
    rank's slice of the sequence (``tp.kv_to_cache``), each Mamba2 layer's
    state stays the rank's heads and its convolution tail goes to the
    rank's chunk of the channels (``tp.conv_to_cache``); the logits are
    gathered over the vocab."""
    _check_family(cfg)
    params = _whole_vocab_params(params)
    h, positions = _inputs_to_h(params, batch, cfg)
    b, s = positions.shape
    max_seq = max_seq or s
    cache = init_cache(cfg, b, max_seq, h.device)
    cd = dtype_of(cfg.compute_dtype)
    attn_layers, ssm_layers = _stack(params, cfg)
    for kind, i in _layer_order(cfg):
        if kind == "attn":
            h, (k, v), _ = _attn_mlp_block(tp.gather_layer(attn_layers[i]),
                                           h, cfg, positions,
                                           cfg.family == "moe")
            tp.kv_to_cache(k, v, cache["k"][i], cache["v"][i], cfg.n_heads,
                           cfg.n_kv)
        else:
            h, state, conv = _ssm_block(tp.gather_layer(ssm_layers[i]), h,
                                        cfg, return_cache=True)
            cache["ssm"]["state"][i] = state
            cache["ssm"]["conv"][i] = tp.conv_to_cache(
                conv.to(cd), cfg.d_inner, cfg.ssm_state)
    cache["pos"].fill_(s)
    h = rmsnorm(h, params["ln_f"])[:, -1:, :]
    if cfg.seq_shard:      # the last position is the last rank's
        h = tp.copy_to_tp(h, seq=True)[:, -1:, :]
    return tp.gather_vocab(logits_fn(params, h, cfg)), cache


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One decode step, tokens (B, 1) -> (logits (B, 1, V), cache). The
    cache is updated in place (K/V written at ``pos``, each layer's SSM
    state and convolution tail replaced) and returned with ``pos`` + 1.
    Under ``tp.sharded``, tensor-parallel on the cache's shards as
    ``prefill`` leaves them."""
    _check_family(cfg)
    params = _whole_vocab_params(params)
    h = embed_tokens(params, tokens.long(), dtype_of(cfg.compute_dtype))
    h = shard(h, ("batch", None, "embed"))
    pos = cache["pos"]
    attn_layers, ssm_layers = _stack(params, cfg)
    for kind, i in _layer_order(cfg):
        if kind == "attn":
            h = _attn_mlp_decode(tp.gather_layer(attn_layers[i]), h, cfg,
                                 cache["k"][i], cache["v"][i], pos,
                                 cfg.family == "moe")
        else:
            st, cv = cache["ssm"]["state"], cache["ssm"]["conv"]
            h, state, conv = _ssm_block_decode(tp.gather_layer(
                ssm_layers[i]), h, cfg, st[i], cv[i])
            st[i] = state
            cv[i] = conv.to(cv.dtype)
    cache["pos"] = pos + 1
    h = rmsnorm(h, params["ln_f"])
    return tp.gather_vocab(logits_fn(params, h, cfg)), cache


# ------------------------------------------------------------------ model
@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def build_model(cfg: ModelConfig) -> Model:
    _check_family(cfg)
    return Model(
        cfg=cfg,
        init=functools.partial(init_params, cfg),
        forward=functools.partial(forward, cfg=cfg),
        loss=functools.partial(loss_fn, cfg=cfg),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg),
    )
