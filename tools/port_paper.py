"""The paper's evaluation (fig8a-d, table2, fig9-fig12) through the port.

Replays the jobs of the reference's ``benchmarks/run.py`` grid (the six
workflows through ``METHODS`` at each ``--ttf``, fig9's full and
incremental retrain on methylseq, fig10's alpha sweep on rnaseq, fig11's
argmax runs, fig12's mag run at ``max(scale, 0.3)``) through the port
(``repro_torch.workflow.paper``) in ``--workers`` processes, longest first,
and prints the reference's figure lines. ``--extra`` adds table2 rows at
ttf 1.0 (``sizey_temporal``, ``ks_plus``). ``--against FILE`` holds every
figure to the reference's at the same scale (``tools/port_paper_reference.py``
makes the file on a CPU): each is printed beside the reference's, its
limit and the paper's number. Each job's wastage, time-integrated
wastage, failures and runtime are held to the reference's replay of the
same job, and the script exits 1 on any breach.

The figures are built here, as the reference's ``SimGrid`` (:class:`Grid`)
and ``bench_fig*``/``bench_table2`` functions (under their figures' names)
build them, from the job records; ``chip_smoke.py`` phase 18 and
``tools/port_paper_reference.py`` build and hold theirs with the same
functions.

On the card (``--device cuda``, the default; it raises without a GPU) the
kernels are built once before the workers start, every Sizey run must
launch K1 and K2 once per predictor dispatch, every K1/K2 shape the grid
launched outside ``chip_smoke.py``'s lists is held to its plain version,
the largest K1 and K2 shapes are timed, and ``nvidia-smi`` samples the
card's utilization (the share of each second with a kernel running) once
a second while the jobs run. Imports nothing of JAX or of the JAX
package.

    python tools/port_paper.py --scale 0.35 --ttf 1.0 0.5 \
        --extra sizey_temporal,ks_plus \
        --against tools/port_paper_reference.json \
        --out chiprun_out/paper_0.35.json
    PYTHONPATH=src python tools/port_paper.py --device cpu --scale 0.05 \
        --ttf 1.0 --workers 4
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402

from repro_torch.workflow import WORKFLOWS, paper  # noqa: E402

# the paper's own figures, printed beside each held one
PAPER = {"fig8a/sizey_vs_best_baseline_pct": 64.58,
         "fig8b/sizey_vs_best_baseline_pct": 60.60,
         "table2_wins": 5, "fig9/reduction_pct": 98.39,
         "fig9/full_ms": 1090.0, "fig9/incremental_ms": 17.5,
         "fig11/mlp": 0.427, "fig11/knn": 0.291, "fig11/forest": 0.194,
         "fig11/linear": 0.088}
# each job's figures, held on their own to the reference file's ``jobs``
JOB_FIGURES = ("wastage_gbh", "temporal_wastage_gbh", "n_failures",
               "total_runtime_h")
# figures recorded but never held: fig9's are wall times of this host
NOT_HELD = ("scale", "fig9/")


class Grid:
    """The reference's ``SimGrid`` over job records keyed by
    ``job_key``: the figure functions below read it as the reference's
    read theirs."""

    def __init__(self, records: dict, scale: float, ttfs=(1.0, 0.5),
                 extra=(), workflows=None):
        self.records, self.scale = records, scale
        self.ttfs, self.extra = tuple(ttfs), tuple(extra)
        self.workflows = (list(WORKFLOWS) if workflows is None
                          else list(workflows))
        self._a0 = paper.default_alpha()

    def rec(self, wf: str, method: str, ttf: float = 1.0,
            scale: float | None = None, alpha: float | None = None) -> dict:
        return self.records[paper.job_key(
            wf, self.scale if scale is None else scale, method, ttf,
            None if alpha == self._a0 else alpha)]

    def agg_wastage(self, method: str, ttf: float) -> float:
        return sum(self.rec(wf, method, ttf)["wastage_gbh"]
                   for wf in self.workflows)

    def agg_runtime(self, method: str, ttf: float) -> float:
        return sum(self.rec(wf, method, ttf)["total_runtime_h"]
                   for wf in self.workflows)

    def failures_by_type(self, method: str, ttf: float) -> list[int]:
        out = []
        for wf in self.workflows:
            out.extend(self.rec(wf, method, ttf)["failures_by_type"].values())
        return out


def fig8ab(grid: Grid, ttf: float, out: dict) -> None:
    rows = {m: grid.agg_wastage(m, ttf) for m in paper.METHODS}
    best = min(v for k, v in rows.items() if k != "sizey")
    out["fig8a" if ttf == 1.0 else "fig8b"] = {
        "wastage_gbh": rows,
        "sizey_vs_best_baseline_pct": 100 * (1 - rows["sizey"] / best)}


def fig8c(grid: Grid, out: dict) -> None:
    res = {}
    for m in paper.METHODS:
        fails = grid.failures_by_type(m, 1.0)
        res[m] = {"median": float(np.median(fails)),
                  "q3": float(np.percentile(fails, 75)),
                  "total": int(np.sum(fails))}
    out["fig8c"] = res


def fig8d(grid: Grid, out: dict) -> None:
    out["fig8d"] = {m: grid.agg_runtime(m, 1.0) for m in paper.METHODS}


def table2(grid: Grid, out: dict) -> None:
    """table2 and its wins; ``grid.extra`` methods' rows (wastage,
    time-integrated wastage, failures) under ``table2_extra``."""
    table = {wf: {m: grid.rec(wf, m)["wastage_gbh"] for m in paper.METHODS}
             for wf in grid.workflows}
    out["table2"] = table
    out["table2_wins"] = sum(
        table[wf]["sizey"] < min(v for k, v in table[wf].items()
                                 if k != "sizey") for wf in grid.workflows)
    if grid.extra:
        out["table2_extra"] = {wf: {m: {k: grid.rec(wf, m)[k] for k in (
            "wastage_gbh", "temporal_wastage_gbh", "n_failures")}
            for m in grid.extra} for wf in grid.workflows}


def fig9(grid: Grid, out: dict) -> None:
    wf = paper.FIG9_WORKFLOW
    t_full = grid.rec(wf, "sizey")["train_ms_median"]
    t_inc = grid.rec(wf, "sizey_incremental")["train_ms_median"]
    out["fig9"] = {"full_ms": t_full, "incremental_ms": t_inc,
                   "reduction_pct": 100 * (1 - t_inc / t_full)}


def fig10(grid: Grid, out: dict) -> None:
    alphas = paper.FIG10_ALPHAS
    per = {a: grid.rec(paper.FIG10_WORKFLOW, "sizey",
                       alpha=a)["wastage_by_type"] for a in alphas}
    out["fig10"] = {t: {str(a): per[a].get(t, 0.0) for a in alphas}
                    for t in paper.FIG10_TASKS}


def fig11(grid: Grid, out: dict) -> None:
    counts = np.zeros(4)
    names = None
    for wf in grid.workflows:
        r = grid.rec(wf, "sizey_argmax")
        counts = counts + np.asarray(r["model_select_counts"])
        names = r["models"]
    shares = counts / max(counts.sum(), 1)
    out["fig11"] = dict(zip(names, map(float, shares)))


def fig12(grid: Grid, scale: float, out: dict) -> None:
    out["fig12"] = grid.rec(paper.FIG12_WORKFLOW, "sizey",
                            scale=scale)["fig12"]


def figures(records: dict, scale: float, ttfs=(1.0, 0.5), extra=(),
            workflows=None) -> dict:
    """The reference's ``out`` dict (``benchmarks/run.py``'s ``main``, the
    roofline left out) from the records of :func:`jobs`."""
    grid = Grid(records, scale, ttfs, extra, workflows)
    out: dict = {"scale": scale}
    fig8ab(grid, 1.0, out)
    if 0.5 in grid.ttfs:
        fig8ab(grid, 0.5, out)
    fig8c(grid, out)
    fig8d(grid, out)
    table2(grid, out)
    fig9(grid, out)
    fig10(grid, out)
    fig11(grid, out)
    fig12(grid, max(scale, paper.FIG12_MIN_SCALE), out)
    return out


def print_figures(out: dict, print=print) -> None:
    """The reference's CSV lines of each figure, with the paper's numbers."""
    for name in ("fig8a", "fig8b"):
        if name not in out:
            continue
        for m, v in out[name]["wastage_gbh"].items():
            print(f"{name}/{m},wastage_gbh={v:.2f}")
        print(f"{name}/sizey_reduction,pct="
              f"{out[name]['sizey_vs_best_baseline_pct']:.2f} (paper: "
              f"{PAPER[name + '/sizey_vs_best_baseline_pct']})")
    for m, r in out["fig8c"].items():
        print(f"fig8c/{m},median_failures_per_type={r['median']:.1f},"
              f"total={r['total']}")
    for m, v in out["fig8d"].items():
        print(f"fig8d/{m},runtime_h={v:.2f}")
    for wf, row in out["table2"].items():
        best = min(v for k, v in row.items() if k != "sizey")
        print(f"table2/{wf}," + ",".join(f"{m}={v:.2f}"
                                         for m, v in row.items())
              + f",sizey_best={row['sizey'] < best}")
    print(f"table2/summary,sizey_best_in={out['table2_wins']}_of_"
          f"{len(out['table2'])} (paper: 5 of 6)")
    for wf, rows in out.get("table2_extra", {}).items():
        print(f"table2_extra/{wf}," + ",".join(
            f"{m}={r['wastage_gbh']:.2f}/tw={r['temporal_wastage_gbh']:.2f}"
            f"/fail={r['n_failures']}" for m, r in rows.items()))
    f9 = out["fig9"]
    print(f"fig9/full,median_train_ms={f9['full_ms']:.2f}")
    print(f"fig9/incremental,median_train_ms={f9['incremental_ms']:.2f}")
    print(f"fig9/reduction,pct={f9['reduction_pct']:.1f} (paper: 98.39, "
          f"1090ms -> 17.5ms)")
    for a in paper.FIG10_ALPHAS:
        print(f"fig10/alpha={a}," + ",".join(
            f"{t}={out['fig10'][t][str(a)]:.2f}" for t in paper.FIG10_TASKS))
    print("fig11/shares," + ",".join(f"{n}={s * 100:.1f}%"
                                     for n, s in out["fig11"].items())
          + "  (paper: mlp=42.7%, knn=29.1%, forest=19.4%, linear=8.8%)")
    f12 = out["fig12"]
    print(f"fig12/prokka,n={f12['n']},early_err="
          f"{f12['early_median_rel_err']:.4f},late_err="
          f"{f12['late_median_rel_err']:.4f},slope="
          f"{f12['slope_per_task']:.2e} (paper: decreasing trend)")


def leaves(d: dict, prefix: str = "") -> dict:
    """The numeric leaves of a nested dict by ``/``-joined path."""
    out = {}
    for k, v in d.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(leaves(v, path + "/"))
        elif isinstance(v, (bool, int, float)) and v is not None:
            out[path] = v
    return out


def held(path: str) -> bool:
    return not any(path == p or path.startswith(p) for p in NOT_HELD)


def compare(out: dict, ref: dict, print=print) -> list:
    """Hold every held figure of ``out`` to ``ref`` (one scale of the
    reference file: its ``figures`` and ``limits``, each limit the largest
    allowed absolute difference, 0 for equal); print each beside the
    reference's, its limit and the paper's; return the breaches. Figures
    ``out`` did not run (``table2_extra`` without ``--extra``) are
    skipped."""
    return _hold(out, ref["figures"], ref["limits"], print)


def compare_jobs(records: dict, ref: dict) -> list:
    """Hold each job record's :data:`JOB_FIGURES` to the same scale's
    ``jobs`` (the reference's unmoved replays) under its ``job_limits``, by
    the figures' rule. This holds every replay on its own, also those the
    figures hold only in part or in a sum: the incremental and argmax
    runs, fig10's alphas and each ttf's. Jobs the reference file lacks are
    breaches; jobs not run are skipped. Returns the breaches."""
    rows = {k: {f: r[f] for f in JOB_FIGURES} for k, r in records.items()}
    return _hold(rows, ref["jobs"], ref["job_limits"], lambda *a: None)


def _hold(out: dict, want: dict, limits: dict, print) -> list:
    got = leaves(out)
    want = leaves({k: v for k, v in want.items() if k in out})
    breaches = []
    print(f"{'figure':<44} {'port':>20} {'reference':>20} {'limit':>11} "
          f"{'paper':>8}  verdict")
    for path, w in want.items():
        g = got.get(path)
        if not held(path):
            print(f"{path:<44} {_num(g):>20} {_num(w):>20} {'not held':>11} "
                  f"{_num(PAPER.get(path)):>8}")
            continue
        tol = limits.get(path, 0.0)
        ok = g is not None and (g == w if tol == 0 else abs(g - w) <= tol)
        if not ok:
            breaches.append((path, g, w, tol))
        print(f"{path:<44} {_num(g):>20} {_num(w):>20} "
              f"{'equal' if tol == 0 else f'{tol:.3e}':>11} "
              f"{_num(PAPER.get(path)):>8}  {'ok' if ok else 'BREACH'}")
    missing = sorted(p for p in got if held(p) and p not in want)
    if missing:
        breaches += [(p, got[p], None, None) for p in missing]
        print(f"figures the reference lacks: {missing}")
    return breaches


def _num(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool) or isinstance(v, int):
        return str(int(v))
    return f"{v:.10g}"


def _init_worker() -> None:
    import torch
    torch.set_num_threads(1)   # thousands of tiny ops: one thread wins


def _run(job, device: str):
    """One job in a worker: its record, with the kernel shapes it launched
    on the card."""
    if device != "cuda":
        return job, paper.run_job(job, device, log=None)
    import chip_smoke
    shapes, restore = chip_smoke._recording_shapes()
    try:
        rec = paper.run_job(job, device, log=None)
    finally:
        restore()
    rec["shapes"] = {k: [[list(s), n] for s, n in c.items()]
                     for k, c in shapes.items()}
    return job, rec


def _cost(job) -> int:
    """A job's expected wall, in tasks through a Sizey path (the numpy
    baselines take a second or two)."""
    from repro_torch.workflow import generate_workflow
    wf, scale, method, _ttf, _alpha = job
    if method not in paper.SIZEY + ("ks_plus",):
        return 0
    return len(generate_workflow(wf, scale=scale).tasks)


def run_grid(jobs, device: str, workers: int, log=print) -> dict:
    """Every job through the port, longest first, in ``workers`` spawned
    processes; the records by job key."""
    order = sorted(jobs, key=_cost, reverse=True)
    out = {}
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(workers, mp_context=ctx,
                                initializer=_init_worker) as pool:
        futs = [pool.submit(_run, job, device) for job in order]
        for fut in cf.as_completed(futs):
            job, rec = fut.result()
            out[paper.job_key(*job)] = rec
            wf, scale, name, ttf, alpha = job
            log(f"# sim {wf:10s} {name:18s} ttf={ttf} scale={scale}"
                f"{'' if alpha is None else f' alpha={alpha}'} "
                f"wastage={rec['wastage_gbh']:10.2f} "
                f"fail={rec['n_failures']:4d} ({rec['wall_s']:.1f}s)",
                flush=True)
    return out


def check_launches(records: dict) -> list:
    """Every Sizey run on the card: K1 and K2 once per predictor dispatch."""
    bad = []
    for key, rec in records.items():
        if key.split("/")[1] not in paper.SIZEY:
            continue
        want = sum(rec["dispatches"].values())
        got = [rec["launches"].get(k, 0)
               for k in ("ensemble_mlp", "knn_predict")]
        if not want or got != [want, want]:
            bad.append((key, got, want))
    return bad


def card_shapes(records: dict) -> dict:
    from collections import Counter
    shapes = {"ensemble_mlp": Counter(), "knn_predict": Counter(),
              "segment_dp": Counter()}
    for rec in records.values():
        for k, pairs in rec.get("shapes", {}).items():
            for s, n in pairs:
                shapes[k][tuple(s)] += n
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.35)
    ap.add_argument("--ttf", type=float, nargs="+", default=[1.0, 0.5])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--extra", default="",
                    help="comma-separated methods added to table2 at ttf "
                         "1.0 (sizey_temporal, ks_plus)")
    ap.add_argument("--workers", type=int, default=7)
    ap.add_argument("--out", default=None,
                    help="write the figures and job records as JSON here")
    ap.add_argument("--against", default=None,
                    help="hold the figures to this reference file")
    args = ap.parse_args()
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    extra = tuple(e for e in args.extra.split(",") if e)
    ttfs = tuple(args.ttf)
    t0 = time.perf_counter()
    gpu = None
    if args.device == "cuda":
        import chip_smoke
        from repro_torch.kernels import _build
        gpu = chip_smoke.gpu_line()
        print(f"[gpu] {gpu}")
        _build.build()
    jobs = paper.jobs(args.scale, ttfs, extra)
    print(f"# {len(jobs)} jobs at scale {args.scale}, ttf {list(ttfs)}, "
          f"extra {list(extra)}, {args.workers} workers on {args.device}",
          flush=True)
    sampler = _sample_utilization() if args.device == "cuda" else None
    try:
        records = run_grid(jobs, args.device, args.workers)
    finally:
        util = _stop_sampler(sampler)
    wall = time.perf_counter() - t0
    out = figures(records, args.scale, ttfs, extra)
    print_figures(out)
    sizey = [r for k, r in records.items()
             if k.split("/")[1] in paper.SIZEY]
    n_sizey = sum(r["n_tasks"] for r in sizey)
    busy = sum(r["wall_s"] for r in sizey)
    print(f"# grid wall {wall:.1f} s; {n_sizey} tasks through Sizey paths "
          f"in {busy:.1f} s of job walls ({busy / max(n_sizey, 1):.4f} s a "
          f"task)" + ("" if gpu is None else f"; {gpu}"))
    if util:
        print(f"# card utilization while the jobs ran (nvidia-smi, once a "
              f"second): mean {sum(util) / len(util):.2f} % over "
              f"{len(util)} samples, median {sorted(util)[len(util) // 2]} %")
    bad = []
    timing = {}
    if args.device == "cuda":
        bad += [("launches", *b) for b in check_launches(records)]
        print(f"[launches] K1 and K2 once per dispatch in every Sizey run: "
              f"{'ok' if not bad else bad}")
        timing = _card_kernels(records)
    result = {"figures": out, "jobs": records, "wall_s": wall,
              "device": args.device, "gpu": gpu, "kernels": timing,
              "utilization_pct": util}
    if args.against:
        ref = json.loads(pathlib.Path(args.against).read_text())
        section = ref["scales"].get(str(args.scale))
        if section is None:
            raise SystemExit(f"{args.against} holds no scale {args.scale}")
        breaches = compare(out, section)
        jobs_bad = compare_jobs(records, section)
        for b in jobs_bad:
            print("# job BREACH", *b)
        result["breaches"] = breaches + jobs_bad
        bad += breaches + jobs_bad
        print(f"# against {args.against}: {len(breaches)} figures and "
              f"{len(jobs_bad)} job figures ({len(records)} jobs x "
              f"{len(JOB_FIGURES)}) outside their limits")
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result, indent=1, default=str))
        print(f"# wrote {args.out}")
    return 1 if bad else 0


def _sample_utilization():
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "1000"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _stop_sampler(proc) -> list:
    """Stop the sampler; its readings (percent)."""
    if proc is None:
        return []
    proc.terminate()
    out, _ = proc.communicate(timeout=30)
    return [int(v) for v in out.split() if v.strip().isdigit()]


def _card_kernels(records: dict) -> dict:
    """Hold every K1/K2 shape the grid launched outside chip_smoke.py's
    lists to its plain version, and time the largest of each."""
    import chip_smoke
    shapes = card_shapes(records)
    k1 = sorted(s for s in shapes["ensemble_mlp"]
                if s not in chip_smoke.K1_SHAPES)
    k2 = sorted(s for s in shapes["knn_predict"]
                if s not in chip_smoke.K2_SHAPES)
    errors = chip_smoke.check_kernels(k1, k2) if k1 or k2 else {}
    big1 = max(shapes["ensemble_mlp"], key=lambda s: (s[1], s))
    big2 = max(shapes["knn_predict"], key=lambda s: (s[0] * s[1], s))
    print(f"[kernels] K1 shapes {sorted(shapes['ensemble_mlp'].items())}")
    print(f"[kernels] K2 shapes {sorted(shapes['knn_predict'].items())}")
    t1 = chip_smoke.time_k1([big1])[big1]
    t2 = chip_smoke.time_k2([big2])[big2]
    return {"errors": errors,
            "ensemble_mlp": {"shape": list(big1),
                             "launches": shapes["ensemble_mlp"][big1], **t1},
            "knn_predict": {"shape": list(big2),
                            "launches": shapes["knn_predict"][big2], **t2}}


if __name__ == "__main__":
    sys.exit(main())
