"""Where the port's serial Sizey replay spends its time on the GPU.

    python3 tools/port_profile.py [--scale 0.1] [--window 40:45]

Replays ``methylseq`` through ``SizeyMethod(device="cuda")``, timing
every predict (``allocate``) and every observe (``complete``) on the host
clock, each ending in a device synchronisation, and the wall time of a
window of completed tasks (``--window a:b``). It then replays the same
trace again, which takes the same decisions, and traces that window with
``torch.profiler``: it prints the device-busy time, its share of the
traced and of the untraced window's wall time (the profiler slows the
host, not the kernels), the number of kernel launches and the kernels
that take most device time. Prints the card's name and power limit
first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--window", default="40:45",
                    help="completed-task range traced by the profiler")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.baselines import SizeyMethod
    from repro_torch.kernels import _build
    from repro_torch.workflow import generate_workflow, simulate

    if not torch.cuda.is_available():
        sys.exit("port_profile: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    _build.build()
    lo, hi = (int(v) for v in args.window.split(":"))
    trace = generate_workflow("methylseq", scale=args.scale)

    def replay(traced: bool):
        method = SizeyMethod(device="cuda")
        walls = {"predict": 0.0, "observe": 0.0}
        state = {"done": 0, "prof": None, "t0": 0.0, "wall": 0.0}
        allocate, complete = method.allocate, method.complete

        def timed_allocate(task):
            t0 = time.perf_counter()
            out = allocate(task)
            walls["predict"] += time.perf_counter() - t0
            return out

        def timed_complete(task, first, attempts):
            if state["done"] == lo:
                torch.cuda.synchronize()
                if traced:
                    state["prof"] = profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    state["prof"].start()
                state["t0"] = time.perf_counter()
            t0 = time.perf_counter()
            complete(task, first, attempts)
            walls["observe"] += time.perf_counter() - t0
            state["done"] += 1
            if state["done"] == hi:
                torch.cuda.synchronize()
                state["wall"] = time.perf_counter() - state["t0"]
                if traced:
                    state["prof"].stop()

        method.allocate, method.complete = timed_allocate, timed_complete
        t0 = time.perf_counter()
        res = simulate(trace, method)
        total = time.perf_counter() - t0
        n = len(res.outcomes)
        print(f"replay ({'traced' if traced else 'untraced'} window): {n} "
              f"tasks in {total:.3f} s ({n / total:.3f} tasks/s); predict "
              f"{walls['predict']:.3f} s, observe {walls['observe']:.3f} s, "
              f"rest {total - walls['predict'] - walls['observe']:.3f} s; "
              f"window {lo}..{hi} wall {state['wall'] * 1e3:.3f} ms; "
              f"wastage_gbh {res.wastage_gbh!r}")
        return state

    plain_wall_us = replay(traced=False)["wall"] * 1e6
    state = replay(traced=True)
    prof = state["prof"]
    if prof is None or plain_wall_us == 0:
        print("window not reached: not measured")
        return
    # device-side entries only (kernels and copies): the aten operators
    # that launched them report the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    wall_us = state["wall"] * 1e6
    if busy_us == 0:
        print("profiler saw no device time: busy share not measured")
        return
    print(f"window tasks {lo}..{hi}: device busy {busy_us / 1e3:.3f} ms; "
          f"traced wall {wall_us / 1e3:.3f} ms, busy "
          f"{100 * busy_us / wall_us:.2f} %, idle "
          f"{100 * (1 - busy_us / wall_us):.2f} %; untraced wall "
          f"{plain_wall_us / 1e3:.3f} ms, busy "
          f"{100 * busy_us / plain_wall_us:.2f} %, idle "
          f"{100 * (1 - busy_us / plain_wall_us):.2f} %; {launches} kernels "
          f"and copies, {launches / (hi - lo):.0f} per task")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:7d}x  "
              f"{e.key[:90]}")
    for name in ("ensemble_mlp_kernel", "knn_predict_kernel"):
        hit = [e for e in events if name in e.key]
        t = sum(e.self_device_time_total for e in hit)
        c = sum(e.count for e in hit)
        print(f"  {name}: {c} launches, {t / 1e3:.3f} ms device time "
              f"({100 * t / busy_us:.2f} % of busy)")


if __name__ == "__main__":
    main()
