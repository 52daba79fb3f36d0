"""End-to-end training launcher (the reference's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --scale e2e-100m --steps 300 --ckpt-dir /tmp/ckpt [--device cpu]

Scales: reduced (CPU smoke), e2e-100m (the ~100M end-to-end example),
full (the real config). Trains on ``--device``, CUDA by default. The
launcher owns the fault-tolerance story: Sizey sizes the job's
memory, a SimulatedOOM triggers the paper's retry ladder with
restart-from-checkpoint. ``main`` also takes a ``sizer`` to share one
``SizeyJobSizer`` (and its history) across runs; by default it makes the
reference's own.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sizing import SizeyJobSizer
from repro_torch.train.loop import SimulatedOOM, Trainer, TrainerConfig
from repro_torch.utils.misc import resolve_device


def _kv_heads(n_kv: int, n_heads: int) -> int:
    """The largest count of KV heads that divides ``n_heads`` and is at
    most ``n_kv``."""
    return max(g for g in range(1, min(n_kv, n_heads) + 1)
               if n_heads % g == 0)


def scaled_config(cfg: ModelConfig, scale: str) -> ModelConfig:
    """The reference's scales. At e2e-100m the reference gives
    min(n_kv, 10) KV heads to 10 query heads, which its own attention
    rejects where that does not divide 10 (granite-3-2b: 8, a ValueError
    in its einsum); the port takes the largest divisor of 10 not above it
    (granite-3-2b: 5), the reference's count wherever the reference runs
    (ROADMAP queue 3)."""
    if scale == "full":
        return cfg
    if scale == "reduced":
        return cfg.reduced()
    if scale == "e2e-100m":
        # ~100M-parameter member of the same family
        kw = dict(
            n_layers=12 if cfg.family != "hybrid" else 12,
            d_model=640, d_ff=2560 if cfg.d_ff else 0,
            n_heads=10 if cfg.n_heads else 0,
            n_kv=_kv_heads(min(cfg.n_kv, 10), 10) if cfg.n_heads else 0,
            head_dim=64 if cfg.n_heads else 0,
            vocab=min(cfg.vocab, 32000),
            n_experts=min(cfg.n_experts, 4),
            ssm_state=min(cfg.ssm_state, 64),
            attn_every=3 if cfg.family == "hybrid" else 0,
            n_patches=min(cfg.n_patches, 16),
            param_dtype="float32", compute_dtype="float32", remat="none",
        )
        return dataclasses.replace(cfg, **kw)
    raise ValueError(scale)


def main(argv=None, sizer: SizeyJobSizer | None = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--scale", default="e2e-100m",
                    choices=["reduced", "e2e-100m", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--sizey", action="store_true",
                    help="size the job's memory with Sizey + OOM ladder")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = scaled_config(get_config(args.arch), args.scale)
    print(f"{cfg.name} [{cfg.family}] ~{cfg.param_count()/1e6:.0f}M params "
          f"on {dev}")

    tc = TrainerConfig(
        steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        compress_grads=args.compress_grads, microbatches=args.microbatches,
        lr=args.lr)

    if args.sizey and sizer is None:
        sizer = SizeyJobSizer(hbm_cap_gb=1024.0, preset_gb=64.0, device=dev)
    elif not args.sizey:
        sizer = None
    job = alloc = None
    if sizer is not None:
        shape = dataclasses.replace(SHAPES["train_4k"],
                                    seq_len=args.seq,
                                    global_batch=args.batch)
        job = sizer.size_job(args.arch, cfg, shape, "local", 1)
        alloc = job.sizing.allocation_gb
        tc = dataclasses.replace(tc, memory_budget_gb=alloc)
        print(f"Sizey allocation: {alloc:.2f} GB "
              f"(source={job.sizing.source})")

    attempt = 0
    while True:
        trainer = Trainer(cfg, tc, device=dev)
        try:
            trainer.train()
            break
        except SimulatedOOM as e:
            trainer = None        # free its tensors before the restart
            attempt += 1
            alloc = sizer.retry_allocation(job, attempt, alloc)
            print(f"OOM-kill: {e}; retry {attempt} at {alloc:.2f} GB "
                  f"(restarting from checkpoint)")
            tc = dataclasses.replace(tc, memory_budget_gb=alloc)
    if sizer is not None:
        sizer.observe_job(job, trainer.footprint_gb(),
                          attempts=attempt + 1)
    print(f"done: final loss {trainer.history[-1]['loss']:.4f} "
          f"({len(trainer.history)} steps this run)")
    return trainer


if __name__ == "__main__":
    main()
