"""Decode on an e4m3 KV cache (``kv_dtype="float8_e4m3fn"``) on the CPU,
the port against the JAX reference on the same numpy inputs.

The reference model casts the cache to the compute type on read and rounds
its probabilities in the compute type (``repro/models/attention.py:
190-203``); the port's decode goes through K5 with P rounded to the
query's type, so in fp32 the two compute the same function: prefill and
8 decode steps of the reduced granite-3-2b, phi3.5-moe and zamba2-7b
(weights carried across by ``convert.lm_params_to_torch``), logits and
cache leaves within 1e-6 of the largest (the caches' e4m3 bytes equal).
One decode attention block with its weights scaled so that the softmax is
far from flat, where a P rounded to the cache's type (the TPU kernel's
function) lies ~1e-2 away, is held to the same 1e-6. In bf16 the reduced
zamba2-7b is held to ``tests/test_torch_bf16_distance.py``'s limits (the
two packages round bf16 at other places). K5's plain version with its
default P type, the cache's, is held to the reference's Pallas kernel in
interpret mode on the same e4m3 cache at K5's bf16 limit, 3e-2: P rounded
to e4m3 keeps 4 significant bits, and a score one fp32 ulp apart may
round P to a neighbouring value (measured up to 4.6e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_decode.ops import flash_decode_attention
from repro.models import attention as j_attention
from repro.models import build_model as j_build_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import attention, build_model, cast_weights
from repro_torch.kernels.flash_decode.ref import flash_decode_plain

torch.set_num_threads(1)
FP8 = "float8_e4m3fn"
TOL = 1e-6
BF16_REL_TOL, BF16_AGREE_MIN = 3e-2, 0.9     # test_torch_bf16_distance.py
K5_FP8_TOL = 3e-2


def _np(x):
    """A leaf of either package as float64 numpy (e4m3 exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(arch, compute="float32"):
    repl = {"kv_dtype": FP8, "compute_dtype": compute}
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **repl)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **repl)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_to_torch(jax.device_get(jp), "cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _serve_both(arch, compute, steps=8, prompt=8):
    jcfg, jm, jp, tcfg, tm, tp = _pair(arch, compute)
    if compute == "bfloat16":
        tp = cast_weights(tp, tcfg)
    toks = np.random.default_rng(len(arch)).integers(
        0, jcfg.vocab, (2, prompt + steps)).astype(np.int32)
    max_seq = prompt + steps
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=max_seq))(
        jp, {"tokens": jnp.asarray(toks[:, :prompt])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :prompt])},
                        max_seq=max_seq)
    pairs = [(tl, jl)]
    decode = jax.jit(jm.decode_step)
    for t in range(prompt, prompt + steps):
        jl, jc = decode(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        pairs.append((tl, jl))
    return jcfg, pairs, tc, jc


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-7b"])
def test_fp8_cache_prefill_and_decode_match_the_reference(arch):
    jcfg, pairs, tc, jc = _serve_both(arch, "float32")
    worst = {f"logits {i}": _rel(t[..., :jcfg.vocab], j[..., :jcfg.vocab])
             for i, (t, j) in enumerate(pairs)}
    assert tc["k"].dtype == torch.float8_e4m3fn
    for name in ("k", "v"):
        assert np.array_equal(tc[name].view(torch.uint8).numpy(),
                              np.asarray(jc[name]).view(np.uint8)), name
    if "ssm" in tc:
        for name in ("state", "conv"):
            worst[name] = _rel(tc["ssm"][name], jc["ssm"][name])
    assert int(tc["pos"]) == int(jc["pos"])
    bad = {k: v for k, v in worst.items() if v > TOL}
    assert not bad, bad


def test_fp8_cache_bf16_lies_near_the_reference():
    jcfg, pairs, _, _ = _serve_both("zamba2-7b", "bfloat16")
    v = jcfg.vocab
    rel = max(_rel(t[..., :v], j[..., :v]) for t, j in pairs)
    agree = sum(int((_np(t[..., :v]).argmax(-1) == _np(j[..., :v])
                     .argmax(-1)).sum()) for t, j in pairs)
    n = sum(t.shape[0] for t, _ in pairs)
    assert 0.0 < rel <= BF16_REL_TOL
    assert agree >= BF16_AGREE_MIN * n


def test_decode_attention_block_rounds_p_as_the_reference_model():
    """One block at pos 40 of a 48-position e4m3 cache, q and k weights
    scaled by 16 so that the scores spread over tens of units: the port
    within 1e-6 of the reference's block, the new K/V bytes equal; a P
    rounded to e4m3 instead (the TPU kernel's function, K5's default)
    moves the block's output far beyond that."""
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              kv_dtype=FP8)
    jcfg = dataclasses.replace(j_get_config("granite-3-2b").reduced(),
                               kv_dtype=FP8)
    rng = np.random.default_rng(7)
    d, qd, kvd = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv * cfg.head_dim
    w = {"wq": rng.normal(0, 16 / d ** 0.5, (d, qd)),
         "wk": rng.normal(0, 16 / d ** 0.5, (d, kvd)),
         "wv": rng.normal(0, 1 / d ** 0.5, (d, kvd)),
         "wo": rng.normal(0, 1 / qd ** 0.5, (qd, d))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.normal(0, 1, (2, 1, d)).astype(np.float32)
    cache = [rng.normal(0, 1, (2, 48, cfg.n_kv, cfg.head_dim))
             .astype(np.float32) for _ in range(2)]
    jk, jv = (jnp.asarray(c).astype(jnp.float8_e4m3fn) for c in cache)
    tk, tv = (torch.from_numpy(c).to(torch.float8_e4m3fn) for c in cache)
    pos = 40
    j_out, jk, jv = j_attention.decode_attention_block(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jcfg, jk,
        jv, pos)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    t_out, tk, tv = attention.decode_attention_block(
        tw, torch.from_numpy(x), cfg, tk, tv,
        torch.tensor(pos, dtype=torch.int32))
    for t, j in ((tk, jk), (tv, jv)):
        assert np.array_equal(t.view(torch.uint8).numpy(),
                              np.asarray(j).view(np.uint8))
    err = _rel(t_out, j_out)
    assert err <= TOL, err
    # the same block with P rounded to the cache's type
    saved = attention.flash_decode
    attention.flash_decode = lambda *a, **kw: flash_decode_plain(
        *a, **{**kw, "p_dtype": None})
    try:
        wrong, _, _ = attention.decode_attention_block(
            tw, torch.from_numpy(x), cfg, tk.clone(), tv.clone(),
            torch.tensor(pos, dtype=torch.int32))
    finally:
        attention.flash_decode = saved
    assert _rel(wrong, j_out) > 100 * TOL


@pytest.mark.parametrize("b,s,h,hkv,d,pos", [
    (2, 1024, 8, 8, 64, 700), (2, 1024, 8, 2, 64, 1023),
    (1, 500, 4, 1, 112, 250), (2, 256, 4, 4, 128, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_on_fp8_matches_the_pallas_kernel(b, s, h, hkv,
                                                             d, pos, dtype):
    rng = np.random.default_rng(s + pos + h + d)
    q = (rng.standard_normal((b, 1, h, d)) * 2).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jk, jv = (jnp.asarray(c).astype(jnp.float8_e4m3fn) for c in (k, v))
    tk, tv = (torch.from_numpy(c).to(torch.float8_e4m3fn) for c in (k, v))
    got = flash_decode_plain(torch.from_numpy(q).to(tdt), tk, tv,
                             torch.tensor(pos, dtype=torch.int32))
    want = flash_decode_attention(jnp.asarray(q).astype(jdt), jk, jv, pos,
                                  interpret=True)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), atol=K5_FP8_TOL,
                               rtol=K5_FP8_TOL)


def test_decode_writes_an_fp8_cache_in_place_on_the_cpu():
    """``index_copy_`` takes no e4m3 (on the CPU or the card): the decode
    step writes the new K/V through a byte view, at ``pos`` and nowhere
    else."""
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              kv_dtype=FP8)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    _, cache = model.prefill(params, {"tokens": toks[:, :8]}, max_seq=12)
    before = cache["k"].view(torch.uint8).clone()
    _, cache = model.decode_step(params, cache, toks[:, 8:])
    after = cache["k"].view(torch.uint8)
    moved = (after != before).any(-1).any(-1).any(1)     # (layers, S)
    assert moved[:, 8].all() and not moved[:, :8].any() \
        and not moved[:, 9:].any()
    assert int(cache["pos"]) == 9
