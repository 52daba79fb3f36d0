"""Where a full-width training step of the port spends its time on the GPU.

    python3 tools/port_train_profile.py [--arch granite-3-2b] [--batch 8] \
        [--seq 256] [--steps 5] [--layers N]

Builds the architecture at full width (``--layers`` cuts the depth) with
random fp32 weights from a seed on the card and AdamW, as
``launch.train --scale full`` trains it, and runs ``--steps`` train steps
of ``--batch`` x ``--seq`` tokens. Untraced, it times the whole step and
its three parts apart on the host clock, each ending in a device
synchronisation: the loss and gradients (forward and backward under the
config's remat), the global-norm clip, and the optimizer update. Then it
traces one step with ``torch.profiler`` and prints the device-busy time
and share, and the device time of K4's forward (``flash_attention_*``
kernels), K4's backward (``attention_bwd_*``), K6's forward
(``ssd_scan_*kernel``) and backward (``ssd_bwd_*``, ``ssd_scan_bwd_*``),
the matrix products
(cuBLAS/CUTLASS GEMM kernels) and the rest (elementwise, reductions and
copies: the casts, the norms, the loss and AdamW), each with its share of
the step, and the kernels that take most device time. Prints the card's
name and power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

# kernel-name fragments of each category, as the profiler names them
CATEGORIES = (
    ("K4 forward", ("flash_attention_wgmma_kernel", "flash_attention_kernel")),
    ("K4 backward", ("attention_bwd_",)),
    ("K6 forward", ("ssd_scan_tc_kernel", "ssd_scan_kernel")),
    ("K6 backward", ("ssd_bwd_", "ssd_scan_bwd_")),
    ("GEMM", ("gemm", "Gemm", "GEMM", "sm90_xmma", "cutlass", "nvjet")),
)


def _category(name: str) -> str:
    for cat, frags in CATEGORIES:
        if any(f in name for f in frags):
            return cat
    return "rest"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import make_optimizer

    if not torch.cuda.is_available():
        sys.exit("port_train_profile: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    _build.build()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.with_layers(args.layers)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    opt = make_optimizer("adamw")
    state = opt.init(params)
    pipe = SyntheticTokenPipeline(cfg.vocab, args.seq, args.batch,
                                  name=cfg.name)
    step = step_mod.make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(pipe.batch_at(0)).to(dev)}
    print(f"{cfg.name}: {cfg.param_count():,} parameters, {cfg.n_layers} "
          f"layers, batch {args.batch} x {args.seq}, remat {cfg.remat}, "
          f"compute {cfg.compute_dtype}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    walls = {"step": [], "loss and gradients": [], "clip": [], "update": []}
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(pipe.batch_at(i)).to(dev)}
        _, t = timed(lambda: step(params, state, batch))
        walls["step"].append(t)
        (_, grads), t = timed(lambda: step_mod._value_and_grad(
            model.loss, params, batch))
        walls["loss and gradients"].append(t)
        (grads, _), t = timed(lambda: step_mod._clip_by_global_norm(grads,
                                                                   1.0))
        walls["clip"].append(t)
        _, t = timed(lambda: opt.update(grads, state, params))
        walls["update"].append(t)
        del grads
    med = {k: statistics.median(v[1:] or v) for k, v in walls.items()}
    tokens = args.batch * args.seq
    print(f"step wall median {med['step']:.4f} s over {args.steps - 1} "
          f"steps after the first ({tokens / med['step']:.1f} tokens/s); "
          f"parts: " + ", ".join(f"{k} {v:.4f} s" for k, v in med.items()
                                 if k != "step")
          + f"; card peak {torch.cuda.max_memory_allocated() / 1024**3:.2f} "
          f"GB")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(v[1] for v in by_name.values())
    if busy <= 0:
        print("torch.profiler showed no device time: device shares not "
              "measured")
        return
    print(f"traced step wall {wall * 1e3:.1f} ms (untraced median "
          f"{med['step'] * 1e3:.1f} ms), device busy {busy:.1f} ms: "
          f"{100 * busy / (med['step'] * 1e3):.2f} % of the untraced wall, "
          f"{sum(v[0] for v in by_name.values())} launches")
    cats: dict[str, list] = {}
    for name, (n, ms) in by_name.items():
        rec = cats.setdefault(_category(name), [0, 0.0])
        rec[0] += n
        rec[1] += ms
    for cat in [c for c, _ in CATEGORIES] + ["rest"]:
        n, ms = cats.get(cat, [0, 0.0])
        print(f"  {cat}: {ms:.2f} ms device time in {n} launches, "
              f"{100 * ms / busy:.2f} % of the busy time, "
              f"{100 * ms / (med['step'] * 1e3):.2f} % of the step wall")
    print("  host and idle: "
          f"{max(med['step'] * 1e3 - busy, 0.0):.2f} ms of the untraced wall")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, ms) in top:
        print(f"    {ms:9.3f} ms  {n:5d}x  {name[:110]}")


if __name__ == "__main__":
    main()
