#!/usr/bin/env python3
"""How far the port's bf16 LM forward lies from the JAX reference's bf16
forward, on the CPU, on the same weights and tokens.

    PYTHONPATH=src python3 tools/port_bf16_distance.py [--layers 6]
        [--batch 2] [--seq 128] [--seed 0]

zamba2-7b at its full width (d_model 3584, 112 SSM heads of 64, the shared
attention block's 32 heads of 112, d_ff 14,336), cut in depth to
``--layers`` layer positions with ``with_layers`` as chip_smoke.py's phase
11 cuts it (6: four Mamba2 positions and two applications of the shared
attention block), compute type bf16. The reference initialises the
weights from ``--seed``; ``convert.lm_params_to_torch`` carries them to
the port; numpy draws the tokens. Both run the full-sequence forward (the
port's plain versions of its kernels, as the CPU runs them) and the tool
prints the largest |logit difference| over the largest |logit| and the
argmax agreement over every position. The two packages round bf16 at
other places (the reference's attention rounds its scores in the compute
type, the port follows the TPU kernels' fp32 scores), so this measures
that gap; ``chip_smoke.py`` phase 10 measures the card's kernels against
the port's plain path, and the two together bound the card's distance
from the reference.

Peaks at ~8 GB at the default depth (the weights in fp32 in both
packages, plus the port's bf16 casts); ~15 s. Needs JAX (the reference)
and PyTorch.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def bf16_distance(jcfg, tcfg, batch: int, seq: int, seed: int):
    """The reference's and the port's bf16 forward logits on the same
    weights (drawn by the reference from ``seed``) and tokens: returns
    (largest |difference| / largest |reference logit|, positions whose
    argmax agrees, positions)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models import build_model as j_build_model
    from repro_torch.convert import lm_params_to_torch
    from repro_torch.models import build_model, cast_weights
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab, (batch, seq)).astype(np.int32)
    jl = np.asarray(jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})[0],
                    np.float32)[..., :jcfg.vocab]
    tp = cast_weights(lm_params_to_torch(jax.device_get(jp), "cpu"), tcfg)
    del jp
    with torch.no_grad():
        tl = tm.forward(tp, {"tokens": torch.from_numpy(toks)})[0]
    tl = tl.float().numpy()[..., :tcfg.vocab]
    rel = float(np.abs(tl - jl).max() / np.abs(jl).max())
    agree = int((tl.argmax(-1) == jl.argmax(-1)).sum())
    return rel, agree, batch * seq


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
    import torch

    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    torch.set_num_threads(min(8, torch.get_num_threads()))
    jcfg = j_get_config("zamba2-7b").with_layers(args.layers)
    tcfg = get_config("zamba2-7b").with_layers(args.layers)
    t0 = time.perf_counter()
    rel, agree, n = bf16_distance(jcfg, tcfg, args.batch, args.seq,
                                  args.seed)
    print(f"[bf16] zamba2-7b full width, {tcfg.n_layers} layer positions "
          f"({tcfg.n_ssm_layers()} Mamba2 + {tcfg.n_attn_layers()} shared "
          f"attention), B={args.batch} S={args.seq}, seed {args.seed}, "
          f"CPU: largest |logit diff| / largest |logit|, port vs reference, "
          f"{rel:.3e}; argmax agreement {agree}/{n} ({agree / n:.4f}); "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
