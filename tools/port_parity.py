"""The paper's comparison through both packages: the port against the JAX
reference, method by method, on every workflow.

Replays the six workflows at one scale through the methods of
``benchmarks/run.py`` (``METHODS``) plus ``sizey_temporal``, ``ks_plus``
and the risk-priced ``sizey_risk`` and ``sizey_risk_temporal``, once
through the reference (``repro``) and once through the
port (``repro_torch``) on the CPU, and prints per (workflow, method) both
packages' wastage (``wastage_gbh``; ``temporal_wastage_gbh`` too where
they differ) and failures, and the deltas. The numpy baselines and KS+
must be identical, and the script exits 1 if one is not; Sizey's deltas
are reported as they come (its MLP's Adam rounds differently in the port,
see tools/port_tolerance.py).

``--cluster N`` replays on the event-driven cluster engine instead
(``simulate_cluster`` on N homogeneous nodes at the trace's machine cap,
``--policy``, root arrivals at ``--arrival-rate``), where the exact
methods must also agree in every ``cluster`` metric. ``--ttf`` sets the
time-to-failure fraction of both packages' methods and engines, and
``--device`` the device of the port's methods that use one (the
reference runs on the CPU). ``--failure-strategy`` sets every method's
crash handling; ``auto`` (picked per task from the risk signals) applies
to the risk methods only, the others keep their default.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/port_parity.py \
        [--scale 0.05] [--workflows methylseq,...] [--ttf 1.0] \
        [--cluster 8 [--policy backfill] [--arrival-rate 30]] \
        [--failure-strategy auto] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

# the methods whose replays must be identical: numpy, or numpy apart from
# the bitwise boundary fit
EXACT = ("witt_wastage", "witt_lr", "tovar_ppm", "witt_percentile",
         "workflow_presets", "ks_plus")
RISK = ("sizey_risk", "sizey_risk_temporal")
ON_DEVICE = ("sizey", "sizey_temporal", "ks_plus") + RISK


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--workflows", default=None,
                    help="comma-separated subset of the six workflows")
    ap.add_argument("--ttf", type=float, default=1.0,
                    help="time-to-failure fraction of an OOM kill")
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="replay on the cluster engine with N nodes "
                         "(0: the serial simulator)")
    ap.add_argument("--policy", default="backfill",
                    help="the cluster engine's placement policy")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson root arrivals a hour (cluster only)")
    ap.add_argument("--failure-strategy", default=None,
                    help="every method's crash handling (auto: the risk "
                         "methods only)")
    ap.add_argument("--device", default="cpu",
                    help="device of the port's methods that use one")
    args = ap.parse_args()
    import torch

    from benchmarks.run import METHODS
    from repro.baselines import make_method as j_make
    from repro.workflow import WORKFLOWS
    from repro.workflow import generate_workflow as j_generate
    from repro.workflow import simulate as j_simulate
    from repro.workflow import simulate_cluster as j_simulate_cluster
    from repro_torch.baselines import make_method
    from repro_torch.workflow import (generate_workflow, simulate,
                                      simulate_cluster)
    torch.set_num_threads(1)   # thousands of tiny ops: one thread wins
    workflows = (args.workflows.split(",") if args.workflows
                 else sorted(WORKFLOWS))
    methods = tuple(METHODS) + ("sizey_temporal", "ks_plus") + RISK
    gen_kw = ({"arrival_rate_per_h": args.arrival_rate} if args.cluster
              else {})

    def run(gen, sim, sim_cluster, method, wf):
        trace = gen(wf, scale=args.scale, **gen_kw)
        if not args.cluster:
            return sim(trace, method, ttf=args.ttf)
        return sim_cluster(trace, method, ttf=args.ttf,
                           n_nodes=args.cluster,
                           node_cap_gb=trace.machine_cap_gb,
                           policy=args.policy)

    where = ("serial" if not args.cluster else
             f"cluster of {args.cluster} nodes, {args.policy}, arrivals "
             f"{args.arrival_rate}/h")
    print(f"scale {args.scale}, ttf {args.ttf}, {where}, failure strategy "
          f"{args.failure_strategy or 'default'}, port on {args.device}")
    print(f"{'workflow':<10} {'method':<20} {'ref GBh':>14} {'port GBh':>14} "
          f"{'rel delta':>10} {'ref tw GBh':>14} {'port tw GBh':>14} "
          f"{'tw delta':>10} {'fail ref/port':>14}")
    bad = []
    for wf in workflows:
        for name in methods:
            fs = args.failure_strategy
            strat = ({} if fs is None or (fs == "auto" and name not in RISK)
                     else {"failure_strategy": fs})
            rj = run(j_generate, j_simulate, j_simulate_cluster,
                     j_make(name, ttf=args.ttf, **strat), wf)
            kw = {"device": args.device} if name in ON_DEVICE else {}
            rt = run(generate_workflow, simulate, simulate_cluster,
                     make_method(name, ttf=args.ttf, **strat, **kw), wf)
            dw = (rt.wastage_gbh - rj.wastage_gbh) / rj.wastage_gbh
            dtw = (rt.temporal_wastage_gbh - rj.temporal_wastage_gbh) \
                / rj.temporal_wastage_gbh
            same = (rt.wastage_gbh == rj.wastage_gbh
                    and rt.temporal_wastage_gbh == rj.temporal_wastage_gbh
                    and rt.n_failures == rj.n_failures
                    and [o.first_alloc_gb for o in rt.outcomes]
                    == [o.first_alloc_gb for o in rj.outcomes]
                    and (rj.cluster is None or dataclasses.asdict(rt.cluster)
                         == dataclasses.asdict(rj.cluster)))
            if name in EXACT and not same:
                bad.append((wf, name))
            print(f"{wf:<10} {name:<20} {rj.wastage_gbh:14.6f} "
                  f"{rt.wastage_gbh:14.6f} {dw:10.3e} "
                  f"{rj.temporal_wastage_gbh:14.6f} "
                  f"{rt.temporal_wastage_gbh:14.6f} {dtw:10.3e} "
                  f"{rj.n_failures:>6}/{rt.n_failures:<6}"
                  f"{'  identical' if same else ''}", flush=True)
    if bad:
        print(f"not identical: {bad}")
        return 1
    print(f"every numpy baseline and KS+ identical on {len(workflows)} "
          f"workflows at scale {args.scale} ({where})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
