"""Measure the spread that sets the port's end-to-end tolerance.

The MLP of each Sizey pool trains 3 learning rates x 300 full-batch Adam
steps on every observe, and Adam turns rounding differences into visible
weight differences; on small pools the learning-rate choice itself can
flip on rounding noise. The port cannot match the reference bit for bit
there, so its tolerance is the reference's own spread: this script
replays a workflow through the JAX package as it is, then again with the
MLP's initial weights moved by one ulp (W1 up, W1 down, W2 up, W2 down),
and prints the largest relative change of any allocation and of the
total wastage, and whether any integer choice (offset index, best model,
failure count) moved. It prints the reference's own wastage and failure
count first, and the range the perturbed replays span last. With
``--port`` it also replays the port (``repro_torch``) on the CPU and
prints the same comparison of the port against the unperturbed reference.

``--method sizey_temporal`` replays the temporal path instead (one
decision per segment; the comparison also counts decisions whose
boundaries moved) and prints, for the unperturbed reference, how many
boundary fits it ran and on how many of them its jitted fit
(``repro.kernels.segment_dp.ops.fit_cuts``) departs from its numpy oracle
(``ref.fit_cuts_ref``), which the port's kernel reproduces.

``--apart POOL`` reports the allocation spread of one pool (task type)
on its own and that of every other pool beside it, so that one pool
whose learning-rate choice flips on rounding noise sets a tolerance for
itself alone.

``--method sizey_risk`` and ``--method sizey_risk_temporal`` replay the
risk-priced paths (with ``--failure-strategy auto``, the per-task crash
handling the risk signals pick); each replay then also prints its risk
rows (count, tau range, collapsed plans) and the strategies it chose.

``--ttf`` sets the method's and the simulator's time-to-failure
fraction, and ``--config key=value`` (repeatable) overrides a field of the
Sizey methods' ``SizeyConfig`` (``incremental=True``, ``strategy=argmax``,
``alpha=0.25``): the configurations of the paper's fig9-fig11. Every
replay also prints its predictor's ``model_select_counts`` (fig11) and,
with ``--log-pool TASK_TYPE``, fig12's early and late median relative
error of that pool's raw aggregate prediction. ``--json PATH`` writes the
unmoved replay's and each moved replay's figures
(``repro_torch.workflow.paper.summarize``) for
``tools/port_paper_reference.py``.

``--cluster N`` replays on the event-driven cluster engine instead of the
serial simulator (``simulate_cluster`` on N homogeneous nodes at the
trace's machine cap, ``--policy``, with root arrivals at
``--arrival-rate`` and node crashes at ``--fail-rate`` from
``--fail-seed``); the decisions are then recorded from the ready waves'
batched predicts, and the engine's waves and predict dispatches are
printed too.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/port_tolerance.py \
        [--workflow methylseq] [--scale 0.05] [--method sizey] \
        [--failure-strategy auto] [--risk-min-samples 2 --risk-window 64] \
        [--seed 0] [--machine-cap 64] [--ttf 0.5] \
        [--config incremental=True] [--log-pool prokka] [--json OUT] \
        [--cluster 8 [--policy backfill] [--arrival-rate 30] \
        [--fail-rate 0.01 --fail-seed 7]] [--samples 4] \
        [--apart POOL] [--port]

The figures it printed on a CPU are quoted beside the assertions of
tests/test_torch_slice.py, tests/test_torch_temporal.py and
tests/test_torch_cluster.py (scale 0.05) and chip_smoke.py (scales 0.05
and 1.0, serial and on the cluster engine, with and without risk).
"""
from __future__ import annotations

import argparse
import functools

import numpy as np


def replay(workflow: str, scale: float, method_name: str = "sizey",
           port: bool = False, engine: dict | None = None,
           failure_strategy: str | None = None,
           trace_kw: dict | None = None, risk_kw: dict | None = None,
           ttf: float = 1.0, config: dict | None = None,
           log_pool: str = "prokka"):
    """One replay: its result, its decisions (one per segment on the
    temporal path, as ``(task_type, source, allocation_gb, offset_idx,
    best model)`` tuples), each decision's boundaries and the predict
    dispatches it ran. ``engine`` holds the cluster engine's options
    (``n_nodes``, ``policy``, ``arrival_rate_per_h``,
    ``fail_rate_per_node_h``, ``fail_seed``); None replays serially.
    ``trace_kw`` goes to ``generate_workflow`` (``seed``,
    ``machine_cap_gb``), ``risk_kw`` to a risk method's ``RiskConfig``,
    ``config`` to the method's ``SizeyConfig``; ``ttf`` is the method's and
    the simulator's. The paper figures of the replay ride the result
    (``res.paper``), fig12's of the ``log_pool`` task type.
    A risk-priced method's risk rows and chosen
    strategies are printed, and its risk rows ride the result
    (``res.risk_rows``)."""
    strat = ({} if failure_strategy is None
             else {"failure_strategy": failure_strategy})
    pkg = "repro_torch" if port else "repro"
    if risk_kw:
        import importlib
        strat["risk"] = importlib.import_module(
            f"{pkg}.core.risk").RiskConfig(**risk_kw)
    if port:
        import torch

        from repro_torch.baselines import make_method
        from repro_torch.core.predictor import DISPATCH_COUNTS
        from repro_torch.workflow import (generate_workflow, simulate,
                                          simulate_cluster)
        torch.set_num_threads(1)   # thousands of tiny ops: one thread wins
        method = make_method(method_name, ttf=ttf, device="cpu", **strat,
                             **(config or {}))
    else:
        from repro.baselines import make_method
        from repro.core.predictor import DISPATCH_COUNTS
        from repro.workflow import (generate_workflow, simulate,
                                    simulate_cluster)
        method = make_method(method_name, ttf=ttf, **strat,
                             **(config or {}))
    strategies = _count_strategies(method)
    decisions, bounds = [], []

    def keep(d, b):
        decisions.append((d.task_type, d.source, float(d.allocation_gb),
                          int(d.offset_idx), None if d.raq is None
                          else int(np.argmax(np.asarray(d.raq)))))
        bounds.append(tuple(b))

    if method.temporal or engine is not None:
        predict_batch = method.predictor.predict_batch

        def recording(tasks):
            out = predict_batch(tasks)
            for d in out:
                for s in getattr(d, "seg_decisions", [d]):
                    keep(s, getattr(d, "boundaries", (1.0,)))
            return out

        method.predictor.predict_batch = recording
    else:
        predict = method.predictor.predict

        def recording(*a, **k):
            d = predict(*a, **k)
            keep(d, (1.0,))
            return d

        method.predictor.predict = recording
    before = DISPATCH_COUNTS["predict_pool"]
    if engine is None:
        res = simulate(generate_workflow(workflow, scale=scale,
                                         **(trace_kw or {})), method,
                       ttf=ttf)
    else:
        kw = dict(engine)
        trace = generate_workflow(
            workflow, scale=scale,
            arrival_rate_per_h=kw.pop("arrival_rate_per_h", None),
            **(trace_kw or {}))
        res = simulate_cluster(trace, method, ttf=ttf,
                               node_cap_gb=trace.machine_cap_gb, **kw)
    res.risk_rows = method.predictor.db.aux.get("risk", [])
    from repro_torch.workflow.paper import summarize
    res.paper = summarize(res, method, log_pool)
    if method.risk is not None:
        print(f"  {'port' if port else 'reference'} {method_name}: "
              f"{risk_summary(method)}; strategies {dict(strategies)}",
              flush=True)
    return res, decisions, bounds, DISPATCH_COUNTS["predict_pool"] - before


def _count_strategies(method):
    """Count the crash handling ``strategy_for`` picks (an empty count
    unless the method picks per task)."""
    from collections import Counter
    counts = Counter()
    if getattr(method, "failure_strategy", None) == "auto":
        pick = method.strategy_for

        def counting(task):
            s = pick(task)
            counts[s] += 1
            return s

        method.strategy_for = counting
    return counts


def risk_summary(method) -> str:
    """A risk-priced method's rows: count, tau range, collapsed plans (the
    package's own ``obs.risk.summarize_risk``)."""
    import importlib
    pkg = type(method).__module__.split(".")[0]
    d = importlib.import_module(f"{pkg}.obs.risk").summarize_risk(
        method.predictor.db.aux.get("risk", []))
    if not d["n"]:
        return "0 risk rows"
    return (f"{d['n']} risk rows, tau {d['tau_min']!r}..{d['tau_max']!r}, "
            f"{d['n_collapsed']} collapsed")


def moved_init(init, sample: int, key, d, h):
    """The reference's MLP init with its weights moved by one ulp: sample
    0..3 move all of W1 up, W1 down, W2 up, W2 down; a later sample moves a
    random half of W1's and W2's elements (seeded by the sample), each up
    or down."""
    import jax
    import jax.numpy as jnp
    w1, b1, w2, b2 = init(key, d, h)
    if sample < 4:
        direction = jnp.inf if sample % 2 == 0 else -jnp.inf
        if sample < 2:
            return jnp.nextafter(w1, direction), b1, w2, b2
        return w1, b1, jnp.nextafter(w2, direction), b2
    keys = jax.random.split(jax.random.PRNGKey(1000 + sample), 4)

    def move(w, k_pick, k_dir):
        pick = jax.random.bernoulli(k_pick, 0.5, w.shape)
        up = jax.random.bernoulli(k_dir, 0.5, w.shape)
        return jnp.where(pick, jnp.nextafter(
            w, jnp.where(up, jnp.inf, -jnp.inf)), w)

    return move(w1, keys[0], keys[1]), b1, move(w2, keys[2], keys[3]), b2


def move_label(sample: int) -> str:
    if sample < 4:
        return f"{'w1' if sample < 2 else 'w2'} " \
               f"{'+' if sample % 2 == 0 else '-'}1 ulp"
    return f"random half +-1 ulp, sample {sample}"


def reference_fit_departures(workflow: str, scale: float,
                             engine: dict | None = None,
                             method_name: str = "sizey_temporal",
                             failure_strategy: str | None = None,
                             trace_kw: dict | None = None,
                             risk_kw: dict | None = None,
                             ttf: float = 1.0, config: dict | None = None,
                             log_pool: str = "prokka"):
    """Replay the reference's temporal path recording every boundary fit;
    return the number of fits and of those where its jitted fit departs
    from its numpy oracle."""
    import repro.core.temporal.predictor as tp
    from repro.kernels.segment_dp.ops import fit_cuts
    from repro.kernels.segment_dp.ref import fit_cuts_ref
    fits = []
    fit = tp.fit_boundaries

    def recording(P, k, **kw):
        fits.append((np.asarray(P, np.float32), int(min(k, P.shape[1]))))
        return fit(P, k, **kw)

    tp.fit_boundaries = recording
    try:
        replay(workflow, scale, method_name, engine=engine,
               failure_strategy=failure_strategy, trace_kw=trace_kw,
               risk_kw=risk_kw, ttf=ttf, config=config, log_pool=log_pool)
    finally:
        tp.fit_boundaries = fit
    departs = sum(not np.array_equal(fit_cuts(P, k), fit_cuts_ref(P, k))
                  for P, k in fits)
    return len(fits), departs


def _moved_replay(sample, workflow, scale, method_name, engine,
                  failure_strategy=None, trace_kw=None, risk_kw=None,
                  ttf=1.0, config=None, log_pool="prokka"):
    """One replay of the reference with the MLP init moved (``sample``)."""
    import repro.core.models.mlp as mlp
    import repro.core.predictor as predictor
    init = mlp._init_params
    mlp._init_params = functools.partial(moved_init, init, sample)
    for fn in (predictor._fused_observe_all, predictor._fused_predict,
               predictor._fused_refresh_all):
        fn.cache_clear()
    try:
        res, d1, b1, _n = replay(workflow, scale, method_name,
                                 engine=engine,
                                 failure_strategy=failure_strategy,
                                 trace_kw=trace_kw, risk_kw=risk_kw,
                                 ttf=ttf, config=config, log_pool=log_pool)
    finally:
        mlp._init_params = init
    return _summary(res), d1, b1


def _summary(res):
    """What the comparison reads of a SimResult."""
    return {"wastage_gbh": res.wastage_gbh,
            "temporal_wastage_gbh": res.temporal_wastage_gbh,
            "n_failures": res.n_failures, "risk_rows": res.risk_rows,
            "paper": res.paper}


def _config(pairs) -> dict:
    """``key=value`` overrides of SizeyConfig, values read as Python
    literals where they parse (``True``, ``0.25``) and as strings else."""
    import ast
    out = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value
    return out


def paper_line(label: str, fig: dict, log_pool: str | None) -> str:
    """A replay's fig11 counts and, for ``log_pool``, fig12's errors."""
    line = (f"{label}: model_select_counts "
            f"{fig.get('model_select_counts')} ({fig.get('models')})")
    if log_pool is not None:
        f12 = fig.get("fig12")
        line += ("; no log for " + log_pool if f12 is None else
                 f"; {log_pool} log n={f12['n']} early median rel err "
                 f"{f12['early_median_rel_err']!r}, late "
                 f"{f12['late_median_rel_err']!r}")
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workflow", default="methylseq")
    ap.add_argument("--seed", type=int, default=0,
                    help="the workflow generator's seed")
    ap.add_argument("--machine-cap", type=float, default=None,
                    help="the workflow's machine cap in GB (default: the "
                         "generator's)")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--method", default="sizey",
                    choices=("sizey", "sizey_temporal", "sizey_risk",
                             "sizey_risk_temporal"))
    ap.add_argument("--risk-min-samples", type=int, default=None,
                    help="a risk method's RiskConfig.min_samples")
    ap.add_argument("--risk-window", type=int, default=None,
                    help="a risk method's RiskConfig.window")
    ap.add_argument("--failure-strategy", default=None,
                    help="the method's crash handling (auto: picked per "
                         "task from the risk signals, risk methods only)")
    ap.add_argument("--samples", type=int, default=4,
                    help="number of 1-ulp moves of the MLP init (the first "
                         "four move all of W1 or W2 up or down; the rest "
                         "move a seeded random half of their elements, "
                         "each up or down)")
    ap.add_argument("--apart", default=None, metavar="POOL",
                    help="report this task type's allocation spread apart "
                         "from that of the other pools")
    ap.add_argument("--port", action="store_true",
                    help="also replay the port on the CPU against the "
                         "reference")
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="replay on the cluster engine with N nodes "
                         "(0: the serial simulator)")
    ap.add_argument("--policy", default="backfill",
                    help="the cluster engine's placement policy")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson root arrivals a hour (cluster only)")
    ap.add_argument("--fail-rate", type=float, default=0.0,
                    help="node crashes a node-hour (cluster only)")
    ap.add_argument("--fail-seed", type=int, default=0)
    ap.add_argument("--ttf", type=float, default=1.0,
                    help="the method's and the simulator's time-to-failure "
                         "fraction")
    ap.add_argument("--config", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="a SizeyConfig override (incremental=True, "
                         "strategy=argmax, alpha=0.25); repeatable")
    ap.add_argument("--log-pool", default=None, metavar="TASK_TYPE",
                    help="print fig12's early and late median errors of "
                         "this pool's log")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write each replay's paper figures here")
    args = ap.parse_args()
    engine = None
    if args.cluster:
        engine = {"n_nodes": args.cluster, "policy": args.policy,
                  "arrival_rate_per_h": args.arrival_rate,
                  "fail_rate_per_node_h": args.fail_rate,
                  "fail_seed": args.fail_seed}

    fs = args.failure_strategy
    tkw = {"seed": args.seed}
    if args.machine_cap is not None:
        tkw["machine_cap_gb"] = args.machine_cap
    rkw = {k: v for k, v in (("min_samples", args.risk_min_samples),
                             ("window", args.risk_window)) if v is not None}
    temporal = args.method in ("sizey_temporal", "sizey_risk_temporal")
    pkw = {"ttf": args.ttf, "config": _config(args.config),
           "log_pool": args.log_pool or "prokka"}
    base, d0, b0, n_predict = replay(args.workflow, args.scale, args.method,
                                     engine=engine, failure_strategy=fs,
                                     trace_kw=tkw, risk_kw=rkw, **pkw)
    where = "serial" if engine is None else (
        f"cluster {engine}, waves={base.cluster.n_waves}, "
        f"makespan_h={base.cluster.makespan_h!r}")
    print(f"reference {args.method} {args.workflow} scale={args.scale} "
          f"ttf={args.ttf} config={pkw['config']} "
          f"({where}): {len(base.outcomes)} tasks, "
          f"wastage_gbh={base.wastage_gbh!r}, "
          f"temporal_wastage_gbh={base.temporal_wastage_gbh!r}, "
          f"n_failures={base.n_failures}, predict dispatches {n_predict}, "
          f"model decisions "
          f"{sum(d[1] == 'model' for d in d0)} of {len(d0)}", flush=True)
    if temporal:
        n, departs = reference_fit_departures(args.workflow, args.scale,
                                              engine, args.method, fs, tkw,
                                              rkw, **pkw)
        print(f"reference boundary fits: {n}; its jitted fit departs from "
              f"its numpy oracle on {departs}", flush=True)
    base = _summary(base)
    print(paper_line("reference", base["paper"], args.log_pool), flush=True)
    papers = [base["paper"]]
    worst_alloc = worst_apart = worst_waste = 0.0
    # the temporal path is judged on the time-integrated wastage
    metric = "temporal_wastage_gbh" if temporal else "wastage_gbh"
    wastes, fails, moved = [base[metric]], [base["n_failures"]], []
    for sample in range(args.samples):
        res, d1, b1 = _moved_replay(sample, args.workflow, args.scale,
                                    args.method, engine, fs, tkw, rkw,
                                    **pkw)
        papers.append(res["paper"])
        print(paper_line(move_label(sample), res["paper"], args.log_pool),
              flush=True)
        alloc, apart, waste, ints = compare(move_label(sample), base, d0,
                                            b0, res, d1, b1, metric,
                                            args.apart)
        worst_alloc = max(worst_alloc, alloc)
        worst_apart = max(worst_apart, apart)
        worst_waste = max(worst_waste, waste)
        wastes.append(res[metric])
        fails.append(res["n_failures"])
        moved.append(ints)
    if moved:
        pools = ("" if args.apart is None else
                 f" outside {args.apart} ({args.apart}: {worst_apart:.3e})")
        print(f"spread over {args.samples} moves: allocation rel "
              f"{worst_alloc:.3e}{pools}, wastage rel {worst_waste:.3e}; "
              f"{metric} "
              f"{min(wastes)!r}..{max(wastes)!r}, n_failures "
              f"{min(fails)}..{max(fails)}, integer choices moved "
              f"{min(moved)}..{max(moved)}")
    if args.json:
        import json
        import pathlib
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({
            "workflow": args.workflow, "scale": args.scale,
            "method": args.method, "ttf": args.ttf, "config": pkw["config"],
            "samples": args.samples, "base": papers[0],
            "moves": papers[1:]}))
    if args.port:
        res, d1, b1, _n = replay(args.workflow, args.scale, args.method,
                                 port=True, engine=engine,
                                 failure_strategy=fs, trace_kw=tkw,
                                 risk_kw=rkw, **pkw)
        compare("port on the CPU", base, d0, b0, _summary(res), d1, b1,
                metric, args.apart)
        print(paper_line("port on the CPU", res.paper, args.log_pool))


def compare(label: str, base, d0, b0, res, d1, b1, metric: str,
            apart: str | None = None):
    """Print how far a replay moved from the unperturbed reference in
    allocations (those of the pool ``apart`` on their own), the wastage
    ``metric``, integer choices, boundaries and failures. ``base`` and
    ``res`` are summaries of the two results, ``d0`` and ``d1`` their
    decisions as :func:`replay` records them."""
    if len(d0) != len(d1):
        # a moved failure changes the retries, and with them the decisions
        print(f"{label}: {len(d1)} decisions against {len(d0)}; compared "
              f"pairwise up to the shorter")
    rel = [(a[0] == apart, abs(a[2] - b[2]) / a[2])
           for a, b in zip(d0, d1) if a[1] == "model"]
    alloc = max((r for inside, r in rel if not inside), default=0.0)
    alloc_apart = max((r for inside, r in rel if inside), default=0.0)
    waste = abs(base[metric] - res[metric]) / base[metric]
    ints = sum(a[1] != b[1] or (a[1] == "model" and a[3:] != b[3:])
               for a, b in zip(d0, d1))
    moved = sum(x != y for x, y in zip(b0, b1))
    pool = "" if apart is None else \
        f" outside {apart} ({apart}: {alloc_apart:.3e})"
    ra, rb = base["risk_rows"], res["risk_rows"]
    rows = max((abs(a["alloc_gb"] - b["alloc_gb"]) / a["alloc_gb"]
                for a, b in zip(ra, rb)), default=0.0)
    risk = "" if not ra else (f", risk rows {len(ra)} -> {len(rb)}, their "
                              f"alloc_gb rel {rows:.3e}")
    print(f"{label}: max alloc rel {alloc:.3e}{pool}, wastage rel "
          f"{waste:.3e} ({metric} {res[metric]!r}), integer "
          f"choices moved {ints}, boundaries moved {moved}, failures "
          f"{base['n_failures']} -> {res['n_failures']}{risk}", flush=True)
    return alloc, alloc_apart, waste, ints


if __name__ == "__main__":
    main()
