"""Where the port's Sizey replay spends its time on the GPU.

    python3 tools/port_profile.py [--scale 0.1] [--window 40:45] \
        [--method sizey|sizey_temporal|sizey_risk|sizey_risk_temporal] \
        [--failure-strategy auto] \
        [--cluster 8 [--arrival-rate 30] [--fail-rate 0.01 --fail-seed 7]]

Replays ``methylseq`` through ``make_method(method, device="cuda")``,
timing
every predict (``allocate``) and every observe (``complete``) on the host
clock, each ending in a device synchronisation, and the wall time of a
window of completed tasks (``--window a:b``). It then replays the same
trace again, which takes the same decisions, and traces that window with
``torch.profiler``: it prints the device-busy time, its share of the
traced and of the untraced window's wall time (the profiler slows the
host, not the kernels), the number of kernel launches and the kernels
that take most device time, with each of the port's kernels' launches
and share. Prints the card's name and power limit first. Needs a CUDA
device.

``--cluster N`` replays on the cluster engine instead (``simulate_cluster``
on N nodes at the trace's machine cap, root arrivals at
``--arrival-rate``, node crashes at ``--fail-rate``): predicts and observes
then come a ready wave at a time (``allocate_batch``, ``complete_batch``),
and the window runs from the first completion wave that starts at or
after task ``a`` to the first that ends at or after task ``b``.
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
    ap.add_argument("--method", default="sizey",
                    choices=("sizey", "sizey_temporal", "sizey_risk",
                             "sizey_risk_temporal"))
    ap.add_argument("--failure-strategy", default=None,
                    help="the method's crash handling (auto: picked per "
                         "task from the risk signals, risk methods only)")
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="replay on the cluster engine with N nodes")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson root arrivals a hour (cluster only)")
    ap.add_argument("--fail-rate", type=float, default=0.0,
                    help="node crashes a node-hour (cluster only)")
    ap.add_argument("--fail-seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.baselines import make_method
    from repro_torch.kernels import _build
    from repro_torch.workflow import (generate_workflow, simulate,
                                      simulate_cluster)

    if not torch.cuda.is_available():
        sys.exit("port_profile: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    _build.build()
    lo, hi = (int(v) for v in args.window.split(":"))
    trace = generate_workflow("methylseq", scale=args.scale,
                              arrival_rate_per_h=(args.arrival_rate
                                                  if args.cluster else None))

    def replay(traced: bool):
        method = make_method(args.method, device="cuda", **(
            {} if args.failure_strategy is None
            else {"failure_strategy": args.failure_strategy}))
        walls = {"predict": 0.0, "observe": 0.0}
        state = {"done": 0, "prof": None, "t0": 0.0, "wall": 0.0,
                 "lo": None, "hi": None}

        def begin():
            if state["lo"] is None and state["done"] >= lo:
                torch.cuda.synchronize()
                if traced:
                    state["prof"] = profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    state["prof"].start()
                state["lo"], state["t0"] = state["done"], time.perf_counter()

        def end(n):
            state["done"] += n
            if (state["lo"] is not None and state["hi"] is None
                    and state["done"] >= hi):
                torch.cuda.synchronize()
                state["wall"] = time.perf_counter() - state["t0"]
                state["hi"] = state["done"]
                if traced:
                    state["prof"].stop()

        def timed(kind, fn, window=None):
            def call(*a):
                if window:
                    begin()
                t0 = time.perf_counter()
                out = fn(*a)
                walls[kind] += time.perf_counter() - t0
                if window:
                    end(window(*a))
                return out
            return call

        # the engine calls the batch APIs, the serial replay the single
        # ones (the temporal method's allocate calls its allocate_batch)
        if args.cluster:
            method.allocate_batch = timed("predict", method.allocate_batch)
            method.complete_batch = timed("observe", method.complete_batch,
                                          len)
        else:
            method.allocate = timed("predict", method.allocate)
            method.complete = timed("observe", method.complete,
                                    lambda *a: 1)
        t0 = time.perf_counter()
        if args.cluster:
            res = simulate_cluster(
                trace, method, n_nodes=args.cluster,
                node_cap_gb=trace.machine_cap_gb,
                fail_rate_per_node_h=args.fail_rate,
                fail_seed=args.fail_seed)
        else:
            res = simulate(trace, method)
        total = time.perf_counter() - t0
        n = len(res.outcomes)
        print(f"replay ({'traced' if traced else 'untraced'} window): {n} "
              f"tasks in {total:.3f} s ({n / total:.3f} tasks/s); predict "
              f"{walls['predict']:.3f} s, observe {walls['observe']:.3f} s, "
              f"rest {total - walls['predict'] - walls['observe']:.3f} s; "
              f"window {state['lo']}..{state['hi']} wall "
              f"{state['wall'] * 1e3:.3f} ms; "
              f"wastage_gbh {res.wastage_gbh!r}, temporal_wastage_gbh "
              f"{res.temporal_wastage_gbh!r}")
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
    lo, hi = state["lo"], state["hi"]
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
    for name in ("ensemble_mlp_kernel", "knn_predict_kernel",
                 "segment_dp_fit_kernel"):
        hit = [e for e in events if name in e.key]
        t = sum(e.self_device_time_total for e in hit)
        c = sum(e.count for e in hit)
        print(f"  {name}: {c} launches, {t / 1e3:.3f} ms device time "
              f"({100 * t / busy_us:.2f} % of busy)")


if __name__ == "__main__":
    main()
