"""Full paper-style simulation on the PyTorch/CUDA port
(``examples/workflow_sim.py`` over ``repro_torch``): six workflows x all
methods x two time-to-failure values, reproducing Fig. 8 / Table II.

Every Sizey method and KS+ run on ``--device`` (CUDA by default; without
a GPU, CUDA raises rather than falling back, and ``--device cpu`` runs
the kernels' plain versions); the numpy baselines, the engine, the
telemetry and the trace ingest run on the host.

    PYTHONPATH=src python examples/port_workflow_sim.py --scale 0.5 \
        --out results/workflow_sim.csv

Scale 1.0 replays the full Table I instance counts (~13.5k tasks/method).

``--cluster [N]`` runs each (workflow, method, ttf) cell on the event-driven
N-node engine instead of the serial replay: instance-level DAG dependencies
gate ready sets, nodes have finite memory, and the CSV gains makespan /
mean node-utilization / queueing-delay columns — the throughput side of the
over- vs under-provisioning trade-off the serial replay cannot show.

The heterogeneous, failure-aware setting (the paper's shared nf-core
clusters, where nodes differ in memory and fail mid-run):

    PYTHONPATH=src python examples/port_workflow_sim.py --cluster \
        --node-caps 16,32,64 --policy best_fit --fail-rate 0.01

``--node-caps`` cycles the listed per-node-class capacities over the node
set AND makes the generated traces heterogeneous (task types cycle over
the matching machine classes, per-machine predictor pools clamp against
their own class capacity); per-node-class utilization is reported per
cell. ``--policy`` picks any registered placement policy (fifo, backfill,
best_fit, spread, preemptive); ``--fail-rate`` injects seeded node
crashes (crashes per node-hour, ``--repair-h`` downtime each).

``--temporal [K]`` adds the time-segmented allocators (sizey_temporal
with K segments, ks_plus) and the time-integrated ``tw_gbh`` column; on
``--cluster`` runs, reservations then resize at predicted segment
boundaries (RESIZE events; ``resizes`` / ``grow_failures`` columns).
``--seed`` threads one master seed through trace generation (peaks,
runtimes, usage curves), Poisson arrivals, and failure injection, so any
CLI run is reproducible from a single number. ``--workflows`` restricts
the sweep to a subset of the six paper workflows.

``--plot-wastage [BASE]`` (with ``--cluster --temporal``) writes a
Fig. 8-style wastage-over-time overlay of the peak sizey vs
sizey_temporal cluster runs — cumulative time-integrated waste and
concurrently wasted GB on one shared event-timestamped axis — to
``BASE.csv`` plus ``BASE.png`` when matplotlib is importable:

    PYTHONPATH=src python examples/port_workflow_sim.py --cluster --temporal \
        --workflows mag --ttf 1.0 --plot-wastage results/wastage_timeline

The expanded failure models (correlated rack outages, stragglers,
Ponder-style failure strategies):

    PYTHONPATH=src python examples/port_workflow_sim.py --cluster \
        --rack-caps "16,32,64;16,32,64" --rack-fail-rate 0.1 \
        --straggler-rate 0.1 --failure-strategy checkpoint

Replaying a REAL scheduler log instead of the synthetic workflows:

    PYTHONPATH=src python examples/port_workflow_sim.py --cluster \
        --trace src/repro_torch/data/sample_traces/sample_jobs_info.txt \
        --trace-nodes src/repro_torch/data/sample_traces/sample_nodes_info.txt \
        --mem-unit mb --time-unit s --time-compress 10

``--trace`` ingests a CraneSched-style ``jobs_info`` log (or a generic
CSV/JSONL trace — the format is picked from the suffix, or forced with
``--trace-format``; see :mod:`repro_torch.data.ingest` for the schemas) and
replays it through every method; ``--trace-nodes`` builds the node set
from the matching ``nodes_info`` table; ``--time-compress R`` divides all
inter-arrival gaps by R (the exemplar's ``Ratio`` knob — raises offered
load without touching runtimes).

``--rack-caps`` gives the cluster an explicit rack topology
(semicolon-separated racks, each a comma list of node capacities) and
makes the trace heterogeneous over the distinct caps; ``--rack-fail-rate``
injects whole-rack outages (events per rack-hour, ``--rack-repair-h``
each); ``--straggler-rate`` stretches a seeded subset of attempts by a
mean factor ``--straggler-factor``; ``--failure-strategy`` picks how
interrupted attempts are charged and re-run (retry_same / retry_scaled /
checkpoint — checkpoint also folds the observed crash rate into Sizey's
offset choice). The CSV gains ``oom_gbh`` / ``interruption_gbh`` /
``rack_failures`` / ``stragglers`` columns.
"""
import argparse
import csv
import os
import time

from repro_torch import obs
from repro_torch.baselines import make_method
from repro_torch.baselines.sizey_method import SizeyMethod
from repro_torch.core import SizeyConfig
from repro_torch.data import load_trace, read_nodes_info
from repro_torch.obs.quality import QUALITY_FIELDS, read_quality_rows
from repro_torch.utils.misc import resolve_device
from repro_torch.workflow import (FAILURE_STRATEGIES, WORKFLOWS,
                                  generate_workflow, node_specs_from_caps,
                                  node_specs_from_racks, simulate,
                                  simulate_cluster)
from repro_torch.workflow.cluster import PLACEMENT_POLICIES, machine_label
from repro_torch.workflow.generators import CURVE_SHAPES

METHODS = ["sizey", "witt_wastage", "witt_lr", "tovar_ppm",
           "witt_percentile", "workflow_presets"]
TEMPORAL_METHODS = ["sizey_temporal", "ks_plus"]


def make(name, ttf, temporal_k, failure_strategy="retry_same",
         cap_gb=128.0, quality=False, device=None):
    """The reference's method of this name; every Sizey method and KS+ on
    ``device``, the numpy baselines on the host."""
    risky = name in ("sizey_risk", "sizey_risk_temporal")
    if failure_strategy == "auto" and not risky:
        # per-pool auto-selection needs the risk signals; the rest of the
        # sweep keeps the pre-risk default so runs stay comparable
        failure_strategy = "retry_same"
    if name == "sizey":
        return SizeyMethod(SizeyConfig(), ttf=ttf, machine_cap_gb=cap_gb,
                           failure_strategy=failure_strategy,
                           quality=quality, device=device)
    if name == "sizey_temporal":
        return SizeyMethod(SizeyConfig(), ttf=ttf, temporal_k=temporal_k,
                           machine_cap_gb=cap_gb,
                           failure_strategy=failure_strategy,
                           quality=quality, device=device)
    if name == "sizey_risk":
        return SizeyMethod(SizeyConfig(), ttf=ttf, machine_cap_gb=cap_gb,
                           name=name, risk=True,
                           failure_strategy=failure_strategy,
                           quality=quality, device=device)
    if name == "sizey_risk_temporal":
        return SizeyMethod(SizeyConfig(), ttf=ttf, temporal_k=temporal_k,
                           machine_cap_gb=cap_gb, name=name, risk=True,
                           failure_strategy=failure_strategy,
                           quality=quality, device=device)
    if name == "ks_plus":
        return make_method(name, ttf=ttf, k_segments=temporal_k,
                           machine_cap_gb=cap_gb,
                           failure_strategy=failure_strategy, device=device)
    return make_method(name, ttf=ttf, machine_cap_gb=cap_gb,
                       failure_strategy=failure_strategy)


def _wastage_series(res):
    """Event-timestamped waste of one cluster run, two step series:
    cumulative time-integrated waste (GB·h, stepping at each task finish)
    and concurrently wasted GB (each task's mean reserved-minus-used
    spread over its [start_h, finish_h] execution interval)."""
    cum, total = [], 0.0
    for t, tw in sorted((o.finish_h, o.tw_gbh) for o in res.outcomes):
        total += tw
        cum.append((t, total))
    deltas = []
    for o in res.outcomes:
        dur = o.finish_h - o.start_h
        if dur > 0:
            deltas.append((o.start_h, o.tw_gbh / dur))
            deltas.append((o.finish_h, -o.tw_gbh / dur))
    rate, level = [], 0.0
    for t, d in sorted(deltas):
        level += d
        rate.append((t, max(level, 0.0)))
    return cum, rate


def _sample_step(series, ts):
    """Values of a step series at each (sorted) timestamp; 0 before the
    first event."""
    out, i, v = [], 0, 0.0
    for t in ts:
        while i < len(series) and series[i][0] <= t + 1e-12:
            v = series[i][1]
            i += 1
        out.append(v)
    return out


def write_wastage_overlay(res_peak, res_temporal, base, title=""):
    """Fig. 8-style overlay: peak vs temporal wastage over cluster time on
    one shared event-timestamped axis. Writes ``base.csv`` always and
    ``base.png`` when matplotlib is importable (the plot is an optional
    artifact — the CSV carries the full series either way)."""
    series = {"peak": _wastage_series(res_peak),
              "temporal": _wastage_series(res_temporal)}
    ts = sorted({t for cum, rate in series.values()
                 for s in (cum, rate) for t, _ in s})
    cols = {}
    for name, (cum, rate) in series.items():
        cols[f"cum_tw_{name}_gbh"] = _sample_step(cum, ts)
        cols[f"wasted_{name}_gb"] = _sample_step(rate, ts)
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    with open(base + ".csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["t_h"] + list(cols))
        for i, t in enumerate(ts):
            w.writerow([round(t, 6)] + [round(cols[c][i], 4) for c in cols])
    print(f"wrote {base}.csv ({len(ts)} event timestamps)")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping the PNG")
        return
    fig, (ax0, ax1) = plt.subplots(2, 1, sharex=True, figsize=(8, 6))
    styles = {"peak": dict(color="tab:red", label="peak (sizey)"),
              "temporal": dict(color="tab:blue",
                               label="temporal (sizey_temporal)")}
    for name, (cum, rate) in series.items():
        ax0.step(ts, cols[f"cum_tw_{name}_gbh"], where="post",
                 **styles[name])
        ax1.step(ts, cols[f"wasted_{name}_gb"], where="post",
                 **styles[name])
    ax0.set_ylabel("cumulative waste (GB·h)")
    ax0.legend(loc="upper left")
    ax1.set_ylabel("concurrently wasted GB")
    ax1.set_xlabel("cluster time (h)")
    if title:
        ax0.set_title(title)
    fig.tight_layout()
    fig.savefig(base + ".png", dpi=120)
    plt.close(fig)
    print(f"wrote {base}.png")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0,
                    help="master seed: threads through trace generation "
                         "(peaks, runtimes, usage curves), Poisson "
                         "arrivals, AND node-failure injection (unless "
                         "--fail-seed overrides), so a CLI run is fully "
                         "reproducible from this one number")
    ap.add_argument("--ttf", type=float, nargs="+", default=[1.0, 0.5])
    ap.add_argument("--temporal", type=int, nargs="?", const=4, default=0,
                    metavar="K",
                    help="add the temporal methods (sizey_temporal with K "
                         "segments, ks_plus) and time-integrated GB*h "
                         "waste columns; with --cluster, reservations "
                         "resize at segment boundaries (RESIZE events)")
    ap.add_argument("--cluster", type=int, nargs="?", const=-1, default=0,
                    metavar="N",
                    help="run on the event-driven engine with N nodes "
                         "(bare --cluster: 8, or one node per --node-caps "
                         "entry; omit for the serial replay)")
    ap.add_argument("--node-caps", default=None, metavar="GB,GB,...",
                    help="comma-separated per-node-class memory capacities, "
                         "e.g. 16,32,64: heterogeneous node set AND "
                         "heterogeneous trace emission (requires --cluster)")
    ap.add_argument("--policy", default="backfill",
                    choices=sorted(PLACEMENT_POLICIES))
    ap.add_argument("--fail-rate", type=float, default=0.0,
                    help="node crashes per node-hour (seeded, deterministic; "
                         "requires --cluster)")
    ap.add_argument("--repair-h", type=float, default=1.0,
                    help="downtime per injected node crash, hours")
    ap.add_argument("--fail-seed", type=int, default=None,
                    help="failure-injection seed (default: --seed)")
    ap.add_argument("--rack-caps", default=None, metavar="GB,GB;GB,GB",
                    help="explicit rack topology: semicolon-separated "
                         "racks, each a comma list of node capacities "
                         "(e.g. 16,32,64;16,32,64). Implies a "
                         "heterogeneous trace over the distinct caps and "
                         "enables --rack-fail-rate; mutually exclusive "
                         "with --node-caps (requires --cluster)")
    ap.add_argument("--rack-fail-rate", type=float, default=0.0,
                    help="correlated rack outages per rack-hour (seeded; "
                         "crashes every node of the rack at once; "
                         "requires --rack-caps)")
    ap.add_argument("--rack-repair-h", type=float, default=2.0,
                    help="downtime per rack outage, hours")
    ap.add_argument("--straggler-rate", type=float, default=0.0,
                    help="per-attempt straggler probability: a straggler's "
                         "wall time (and reservation GB*h) stretches by "
                         "a seeded factor (requires --cluster)")
    ap.add_argument("--straggler-factor", type=float, default=4.0,
                    help="mean slowdown of a straggler attempt "
                         "(1 + Exp(factor - 1) draw)")
    ap.add_argument("--failure-strategy", default="retry_same",
                    choices=list(FAILURE_STRATEGIES) + ["auto"],
                    help="how interrupted attempts are charged and re-run "
                         "(checkpoint additionally folds the observed "
                         "crash rate into Sizey's offset choice; auto "
                         "lets the risk layer pick per pool — requires "
                         "--risk, sizey methods only)")
    ap.add_argument("--risk", action="store_true",
                    help="add the risk-priced sizey variants (sizey_risk, "
                         "plus sizey_risk_temporal with --temporal): the "
                         "paper offset is replaced by a conformal "
                         "uncertainty band priced from cluster pressure "
                         "and crash exposure (repro_torch.core.risk)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrival rate (roots/hour) for the "
                         "cluster engine's open-system load model")
    ap.add_argument("--workflows", nargs="+", default=None, metavar="WF",
                    choices=sorted(WORKFLOWS),
                    help="subset of workflows to run (default: all six)")
    ap.add_argument("--curve-shapes", nargs="+", default=None,
                    metavar="SHAPE", choices=CURVE_SHAPES,
                    help="restrict generated usage-curve shapes (e.g. "
                         "ramp — the workload where time-segmented "
                         "reservations pay off most; default: all)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="replay an ingested scheduler log instead of the "
                         "synthetic workflows (CraneSched jobs_info, CSV, "
                         "or JSONL; see repro_torch.data.ingest)")
    ap.add_argument("--trace-format", default="auto",
                    choices=["auto", "jobs_info", "csv", "jsonl"],
                    help="trace file format (auto: pick from the suffix)")
    ap.add_argument("--trace-nodes", default=None, metavar="FILE",
                    help="build the cluster node set from a nodes_info "
                         "table (requires --trace and --cluster)")
    ap.add_argument("--time-compress", type=float, default=1.0, metavar="R",
                    help="divide the ingested trace's inter-arrival gaps "
                         "by R (raises offered load; runtimes untouched)")
    ap.add_argument("--peak-frac", type=float, default=1.0,
                    help="jobs_info logs carry requests, not measured "
                         "peaks: set actual_peak = peak_frac * request "
                         "(< 1 models the usual request inflation)")
    ap.add_argument("--mem-unit", default="mb",
                    choices=["b", "kb", "mb", "gb"],
                    help="memory unit of the ingested log (default: mb)")
    ap.add_argument("--time-unit", default="s", choices=["s", "m", "h"],
                    help="time unit of the ingested log (default: s)")
    ap.add_argument("--plot-wastage", nargs="?", default=None,
                    const="results/wastage_timeline", metavar="BASE",
                    help="write a Fig. 8-style wastage-over-time overlay "
                         "(peak sizey vs sizey_temporal on one shared "
                         "event-timestamped axis, first workflow/ttf "
                         "cell) to BASE.csv and BASE.png; requires "
                         "--cluster and --temporal")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="record spans for the whole sweep and write a "
                         "Chrome/Perfetto trace_event JSON (open in "
                         "ui.perfetto.dev) — telemetry is side-effect-"
                         "free, results are bitwise those of an untraced "
                         "run")
    ap.add_argument("--quality-out", default=None, metavar="FILE",
                    help="run the sizey methods with prediction-quality "
                         "telemetry and write the per-pool time series "
                         "(RAQ, selected model, offset, prequential "
                         "error, retrain cadence) as one CSV; render it "
                         "with examples/port_quality_report.py")
    ap.add_argument("--out", default="results/workflow_sim.csv")
    ap.add_argument("--device", default=None,
                    help="torch device for the Sizey methods and KS+ "
                         "(default: cuda; 'cpu' runs the kernels' plain "
                         "versions)")
    args = ap.parse_args()
    if args.failure_strategy == "auto" and not (args.risk and args.cluster):
        ap.error("--failure-strategy auto selects per pool from the risk "
                 "signals; combine it with --risk and --cluster")
    if args.plot_wastage and not (args.cluster and args.temporal):
        ap.error("--plot-wastage overlays the cluster engine's peak vs "
                 "temporal runs; combine it with --cluster and --temporal")
    for flag, val in (("--arrival-rate", args.arrival_rate),
                      ("--node-caps", args.node_caps),
                      ("--fail-rate", args.fail_rate),
                      ("--rack-caps", args.rack_caps),
                      ("--rack-fail-rate", args.rack_fail_rate),
                      ("--straggler-rate", args.straggler_rate),
                      # non-default settings of the tuning knobs are as
                      # silently-ignored as their siblings: be loud too
                      ("--repair-h",
                       args.repair_h != ap.get_default("repair_h")),
                      ("--rack-repair-h",
                       args.rack_repair_h != ap.get_default("rack_repair_h")),
                      ("--straggler-factor",
                       args.straggler_factor
                       != ap.get_default("straggler_factor")),
                      ("--failure-strategy",
                       args.failure_strategy
                       != ap.get_default("failure_strategy"))):
        if val and not args.cluster:
            ap.error(f"{flag} only affects the event-driven engine; "
                     f"combine it with --cluster [N] (the serial replay "
                     f"ignores it)")
    if args.rack_caps and args.node_caps:
        ap.error("--rack-caps already fixes the node set; drop --node-caps")
    if args.rack_fail_rate and not args.rack_caps:
        ap.error("--rack-fail-rate needs a rack topology: add --rack-caps")
    if args.trace is None:
        for flag, val in (("--trace-nodes", args.trace_nodes),
                          ("--time-compress", args.time_compress != 1.0),
                          ("--peak-frac", args.peak_frac != 1.0)):
            if val:
                ap.error(f"{flag} shapes an ingested log; add --trace FILE")
    else:
        if args.workflows:
            ap.error("--trace replaces the synthetic workflows; "
                     "drop --workflows")
        if args.node_caps or args.rack_caps:
            ap.error("--trace fixes the workload (use --trace-nodes or "
                     "--cluster N for the node set); drop "
                     "--node-caps/--rack-caps")
        if args.trace_nodes and not args.cluster:
            ap.error("--trace-nodes builds a cluster node set; "
                     "add --cluster")
    dev = resolve_device(args.device)

    caps = machine_caps = node_specs = None
    if args.node_caps:
        caps = [float(c) for c in args.node_caps.split(",")]
        machine_caps = {machine_label(c): c for c in caps}
    n_nodes = args.cluster
    if args.rack_caps:
        try:
            node_specs = node_specs_from_racks(
                [[float(c) for c in grp.split(",") if c]
                 for grp in args.rack_caps.split(";") if grp])
        except ValueError as e:
            ap.error(str(e))
        if n_nodes not in (-1, len(node_specs)):
            ap.error(f"--rack-caps names {len(node_specs)} nodes; drop the "
                     f"--cluster count or make it match")
        n_nodes = len(node_specs)
        caps = sorted({s.cap_gb for s in node_specs})
        machine_caps = {machine_label(c): c for c in caps}
    elif n_nodes == -1:
        n_nodes = len(caps) if caps else 8
    if caps and node_specs is None:
        try:
            node_specs = node_specs_from_caps(caps, n_nodes=n_nodes)
        except ValueError as e:   # e.g. --cluster N drops node classes
            ap.error(str(e))

    ingested = None
    if args.trace:
        try:
            fmt = args.trace_format
            if fmt == "auto":
                suffix = os.path.splitext(args.trace)[1].lower()
                fmt = {".csv": "csv", ".jsonl": "jsonl",
                       ".json": "jsonl"}.get(suffix, "jobs_info")
            kw = {"mem_unit": args.mem_unit, "time_unit": args.time_unit,
                  "time_compress": args.time_compress}
            if fmt == "jobs_info":   # peak_frac only applies to request logs
                kw["peak_frac"] = args.peak_frac
            elif args.peak_frac != 1.0:
                ap.error("--peak-frac only applies to jobs_info request "
                         "logs (CSV/JSONL traces carry measured peaks)")
            ingested = load_trace(args.trace, format=fmt, **kw)
            if args.trace_nodes:
                node_specs = read_nodes_info(args.trace_nodes,
                                             mem_unit=args.mem_unit)
                n_nodes = len(node_specs)
        except (OSError, ValueError) as e:
            ap.error(str(e))
        if n_nodes == -1:
            n_nodes = 8
        print(f"ingested {args.trace}: {len(ingested.tasks)} tasks, "
              f"{len(ingested.task_types)} pools, "
              f"cap {ingested.machine_cap_gb:g} GB"
              + (f", {n_nodes} nodes" if args.cluster else ""))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fail_seed = args.seed if args.fail_seed is None else args.fail_seed
    methods = METHODS + (TEMPORAL_METHODS if args.temporal else [])
    if args.risk:
        methods = methods + ["sizey_risk"] + (
            ["sizey_risk_temporal"] if args.temporal else [])
    collector = obs.start_tracing() if args.trace_out else None
    rows = []
    quality_rows: list[dict] = []
    plot_res: dict[str, object] = {}
    for wf in ([ingested.name] if ingested else (args.workflows or WORKFLOWS)):
        if ingested is not None:
            trace = ingested
        else:
            gen_kw = {}
            if args.curve_shapes:
                gen_kw["curve_shapes"] = tuple(args.curve_shapes)
            trace = generate_workflow(wf, seed=args.seed, scale=args.scale,
                                      machine_caps_gb=machine_caps,
                                      arrival_rate_per_h=args.arrival_rate,
                                      **gen_kw)
        for ttf in args.ttf:
            for m in methods:
                t0 = time.time()
                if args.cluster:
                    method = make(m, ttf, args.temporal,
                                  args.failure_strategy,
                                  cap_gb=trace.machine_cap_gb,
                                  quality=bool(args.quality_out),
                                  device=dev)
                    r = simulate_cluster(
                        trace, method,
                        ttf=ttf, n_nodes=n_nodes,
                        node_specs=node_specs, policy=args.policy,
                        fail_rate_per_node_h=args.fail_rate,
                        repair_h=args.repair_h, fail_seed=fail_seed,
                        rack_fail_rate_per_h=args.rack_fail_rate,
                        rack_repair_h=args.rack_repair_h,
                        straggler_rate=args.straggler_rate,
                        straggler_factor=args.straggler_factor)
                else:
                    method = make(m, ttf, args.temporal,
                                  cap_gb=trace.machine_cap_gb,
                                  quality=bool(args.quality_out),
                                  device=dev)
                    r = simulate(trace, method, ttf=ttf)
                if args.quality_out and getattr(method, "quality", False):
                    for q in read_quality_rows(method.predictor.db):
                        quality_rows.append(
                            {"workflow": wf, "method": m, "ttf": ttf, **q})
                row = {
                    "workflow": wf, "method": m, "ttf": ttf,
                    "wastage_gbh": round(r.wastage_gbh, 2),
                    "failures": r.n_failures,
                    "runtime_h": round(r.total_runtime_h, 2),
                    "n_tasks": len(trace.tasks),
                    "wall_s": round(time.time() - t0, 1),
                }
                if args.temporal:
                    # time-integrated waste: the one GB*h axis peak and
                    # temporal allocators share
                    row["tw_gbh"] = round(r.temporal_wastage_gbh, 2)
                if r.cluster is not None:
                    c = r.cluster
                    row.update({
                        "policy": c.policy,
                        "makespan_h": round(c.makespan_h, 3),
                        # capacity-weighted: fraction of cluster memory used
                        "mean_util": round(c.mean_util, 3),
                        # per-node-class utilization (heterogeneous runs)
                        "class_util": "|".join(
                            f"{cls}={u:.3f}"
                            for cls, u in sorted(c.class_util.items())),
                        "queue_delay_h": round(c.mean_queue_delay_h, 4),
                        "waves": c.n_waves,
                        "aborted": c.n_aborted,
                        "preemptions": c.n_preemptions,
                        "node_failures": c.n_node_failures,
                        "interruptions": sum(o.interruptions
                                             for o in r.outcomes),
                        # failure-model expansion: waste split by cause +
                        # the correlated/straggler injection counters
                        "strategy": c.failure_strategy,
                        "oom_gbh": round(r.oom_wastage_gbh, 2),
                        "interruption_gbh":
                            round(r.interruption_wastage_gbh, 2),
                        "failure_events": c.n_failure_events,
                        "rack_failures": c.n_rack_failures,
                        "stragglers": c.n_straggler_attempts,
                    })
                    if args.temporal:
                        row.update({"resizes": c.n_resizes,
                                    "grow_failures": c.n_grow_failures})
                rows.append(row)
                print(row, flush=True)
                if (args.plot_wastage and m in ("sizey", "sizey_temporal")
                        and m not in plot_res):
                    # first (workflow, ttf) cell of each: the overlay pair
                    plot_res[m] = (wf, ttf, r)
    if args.plot_wastage:
        wf, ttf, peak = plot_res["sizey"]
        _, _, temporal = plot_res["sizey_temporal"]
        write_wastage_overlay(
            peak, temporal, args.plot_wastage,
            title=f"{wf} on {n_nodes} nodes (ttf={ttf}, "
                  f"scale={args.scale}, k={args.temporal})")
    if collector is not None:
        obs.stop_tracing()
        os.makedirs(os.path.dirname(args.trace_out) or ".", exist_ok=True)
        collector.write_chrome_trace(args.trace_out)
        print(f"wrote {args.trace_out} ({collector.total_spans()} spans)")
    if args.quality_out:
        os.makedirs(os.path.dirname(args.quality_out) or ".", exist_ok=True)
        with open(args.quality_out, "w", newline="") as f:
            w = csv.DictWriter(
                f, fieldnames=["workflow", "method", "ttf", *QUALITY_FIELDS],
                extrasaction="ignore")
            w.writeheader()
            w.writerows(quality_rows)
        print(f"wrote {args.quality_out} ({len(quality_rows)} samples)")
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=rows[0].keys())
        w.writeheader()
        w.writerows(rows)
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
