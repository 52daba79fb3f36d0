"""Batched serving from the command line (the reference's ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \
        --requests 16 --max-new 24 [--device cpu]

Serves the architecture's reduced configuration (as the reference does)
on ``--device``, CUDA by default; ``chip_smoke.py`` serves zamba2-7b at
full width from the same functions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import SizeyConfig
from repro_torch.launch.sizing import KVCacheSizer
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.utils.misc import resolve_device


def main(argv=None) -> ServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device=dev)
    engine = ServeEngine(model, params, max_batch=args.batch, max_seq=256,
                         temperature=args.temperature, device=dev,
                         sizer=KVCacheSizer(SizeyConfig(min_history=2),
                                            device=dev))

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        rng.integers(8, 32)).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]

    t0 = time.time()
    completions = engine.serve(reqs)
    dt = time.time() - t0
    tok = sum(len(c.tokens) for c in completions)
    print(f"{len(completions)} completions, {tok} tokens in {dt:.1f}s "
          f"({tok/dt:.1f} tok/s) on {dev}, {engine.stats['batches']} "
          f"batches, last KV cache {engine.stats['kv_bytes']/1024**2:.1f} MiB")
    return engine


if __name__ == "__main__":
    main()
