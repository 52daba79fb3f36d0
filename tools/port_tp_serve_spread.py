"""The reference's own spread at the tensor-parallel serve tests' inputs.

``tests/test_torch_tp_serve.py`` holds the port's tensor-parallel prefill
and decode of each reduced config (granite-3-2b, phi3.5-moe, mamba2-780m,
zamba2-7b; the reference's parameters from ``PRNGKey(0)``, a prompt (4,
32) from ``default_rng(1)``, 8 greedy decode steps, a 40-position cache)
to the single-device steps: every step's logits and every cache leaf
within 1e-6 of the largest |value|. Summation order alone moves them (the
row-parallel products' partial sums, the slices' log-sum-exp merge). This
script runs the JAX reference's prefill and decode steps
(``repro.models``) on the same parameters and tokens, then again with
every weight moved one ulp up and one ulp down (``np.nextafter``), the
decode steps fed the unmoved run's greedy tokens, and prints, per config,
the largest relative change of any step's logits (over the true vocab)
and of any cache leaf. The test takes twice these where they exceed 1e-6.

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/port_tp_serve_spread.py
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model

ARCHS = ("granite-3-2b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
         "zamba2-7b")
BATCH, PROMPT, STEPS = 4, 32, 8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _serve(model, params, prompt, feed=None):
    """(each step's logits over the vocab, each cache leaf after the last
    step, the greedy tokens fed)."""
    cfg = model.cfg
    prefill = jax.jit(lambda p, b: model.prefill(p, b,
                                                 max_seq=PROMPT + STEPS))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)})
    steps, fed = [np.asarray(logits)[..., :cfg.vocab]], []
    for i in range(STEPS):
        tok = feed[i] if feed is not None else np.asarray(
            logits[:, -1, :cfg.vocab].argmax(-1))[:, None].astype(np.int32)
        fed.append(tok)
        logits, cache = decode(params, cache, jnp.asarray(tok))
        steps.append(np.asarray(logits)[..., :cfg.vocab])
    return steps, jax.tree_util.tree_leaves(cache), fed


def spread(arch: str) -> dict:
    cfg = j_get_config(arch).reduced()
    model = j_build_model(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(0)))
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    steps, cache, fed = _serve(model, params, prompt)
    out = {"logits": 0.0, "cache": 0.0}
    for direction in (np.inf, -np.inf):
        moved = jax.tree_util.tree_map(
            lambda w: np.nextafter(w, np.array(direction, w.dtype))
            if np.issubdtype(w.dtype, np.floating) else w, params)
        m_steps, m_cache, _ = _serve(model, moved, prompt, fed)
        out["logits"] = max(out["logits"], *(_rel(a, b) for a, b in
                                             zip(m_steps, steps)))
        out["cache"] = max(out["cache"], *(
            _rel(np.asarray(a, np.float32), np.asarray(b, np.float32))
            for a, b in zip(m_cache, cache)
            if np.issubdtype(np.asarray(b).dtype, np.floating)))
    return out


def main() -> None:
    res = {arch: spread(arch) for arch in ARCHS}
    for arch, r in res.items():
        print(f"{arch}: logits {r['logits']:.4e}, cache {r['cache']:.4e}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
