"""Where the port's LM serving step spends its time on the GPU.

    python3 tools/port_lm_profile.py [--batch 8] [--prompt 2048] \
        [--steps 8] [--layers 81]

Builds zamba2-7b at full width (``--layers`` cuts the depth) with random
bf16 weights from a seed on the card, then runs one prefill of
``--batch`` prompts of ``--prompt`` tokens and ``--steps`` decode steps
twice: untraced, timing each on the host clock (each ending in a device
synchronisation), then traced with ``torch.profiler``. For the prefill and
for a decode step it prints the wall time, the device-busy time (kernels
and copies), the busy and idle shares of the untraced wall, the launches,
the kernels that take most device time and each of K4, K5 and K6's
launches and share. It also times the serving engine's sampler at
temperature 0.8, whose Gumbel draws run on the card, beside the same
draws on the host (``core.prng``, uploaded), in the same call. Prints the
card's name and power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

# the CUDA kernels of K4 (bf16), K5 (one launch: the splits merge in their
# cluster) and K6 (bf16, on the tensor cores), as the profiler names them
KERNELS = ("flash_attention_wgmma_kernel", "flash_decode_split_kernel",
           "ssd_scan_tc_kernel")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=81)
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import prng, prng_device
    from repro_torch.kernels import _build
    from repro_torch.models import build_model, cast_weights
    from repro_torch.serving.engine import ServeEngine

    if not torch.cuda.is_available():
        sys.exit("port_lm_profile: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    _build.build()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=args.layers)
    model = build_model(cfg)
    params = cast_weights(model.init(0, device=dev), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.prompt)).astype(np.int32)).to(dev)
    max_seq = args.prompt + args.steps

    def run(prof=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks},
                                      max_seq=max_seq)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        if prof is not None:
            prof.step()
        t_dec = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(
                params, cache, logits[:, -1].argmax(-1)[:, None])
            torch.cuda.synchronize()
            t_dec.append(time.perf_counter() - t0)
        return t_pre, t_dec, logits

    run()                                     # warm-up: builds and caches
    t_pre, t_dec, logits = run()
    print(f"zamba2-7b full width, {cfg.n_layers} layer positions, bf16, "
          f"B={args.batch} prompt {args.prompt}: prefill {t_pre:.4f} s; "
          f"decode step {1e3 * np.median(t_dec):.3f} ms (median of "
          f"{args.steps})")
    sampler = ServeEngine(model, params, temperature=0.8, device=dev)
    shape = tuple(logits[:, -1].shape)

    def host_draw():
        key = prng.split(prng.prng_key(0))[1]
        u = prng.uniform(key, shape, prng_device.F32_TINY, 1.0)
        noise = torch.from_numpy(-prng.log_f32(-prng.log_f32(u))).to(dev)
        return torch.argmax(noise + logits[:, -1] / 0.8, dim=-1)

    for name, draw in (("on the card", lambda: sampler._sample(logits)),
                       ("on the host (core.prng, uploaded)", host_draw)):
        draw().tolist()                       # warm-up
        t0 = time.perf_counter()
        for _ in range(args.steps):
            draw().tolist()
        t_samp = (time.perf_counter() - t0) / args.steps
        print(f"sampler at temperature 0.8 over {shape[0]} x {shape[1]} "
              f"logits, Gumbel draws {name}: {1e3 * t_samp:.3f} ms a step")

    # the profiler's first window holds the prefill, the second the steps
    windows: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=0, active=1,
                                                  repeat=2),
                 on_trace_ready=lambda p: windows.append(p.key_averages())
                 ) as prof:
        run(prof)
        prof.step()
    for name, events, wall in (("prefill", windows[0], t_pre),
                               (f"{args.steps} decode steps", windows[1],
                                sum(t_dec))):
        # device-side entries only (kernels and copies), without the
        # profiler's own step annotation, which spans the whole window
        dev_ev = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("ProfilerStep")]
        busy = sum(e.self_device_time_total for e in dev_ev) / 1e6
        launches = sum(e.count for e in dev_ev)
        if busy == 0:
            print(f"{name}: the profiler saw no device time: not measured")
            continue
        print(f"{name}: device busy {busy:.4f} s of the untraced wall "
              f"{wall:.4f} s: busy {100 * busy / wall:.2f} %, idle "
              f"{100 * (1 - busy / wall):.2f} %; {launches} kernels and "
              f"copies")
        for e in sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
                  f"{e.count:6d}x  {e.key[:90]}")
        for k in KERNELS:
            hit = [e for e in dev_ev if k in e.key]
            t = sum(e.self_device_time_total for e in hit) / 1e6
            print(f"  {k}: {sum(e.count for e in hit)} launches, "
                  f"{1e3 * t:.3f} ms ({100 * t / busy:.2f} % of busy)")


if __name__ == "__main__":
    main()
