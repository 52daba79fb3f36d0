"""Make ``tools/port_paper_reference.json``: the reference's paper figures
at one scale and a limit for each, for ``tools/port_paper.py --against``.

Runs on a CPU with the JAX package. For each Sizey job of the grid
(``repro_torch.workflow.paper.jobs``: the sizey runs at each ttf, fig9's
incremental run, fig10's alphas, fig11's argmax runs, fig12's mag run and
the ``--extra`` rows) it starts ``tools/port_tolerance.py`` with the job's
ttf and config, ``--samples`` 1-ulp moves of the MLP init and ``--json``,
``--procs`` at a time; the numpy baselines and KS+ replay here through
the reference. From the records it builds the figures of the unmoved
replays and of each move (move s of every job together) with
``tools/port_paper.py``'s ``figures``; each held figure's limit is twice
the largest difference of a move's figure from the unmoved one (0: equal,
as it is for the numpy baselines and KS+, which no move reaches). The
limits of each job's wastage, time-integrated wastage, failures and
runtime are set the same way.

The reference's own harness output (``python -m benchmarks.run ... --out
FILE``) is given as ``--bench FILE``: its figures are the file's, and the
script reports every held figure where the unmoved replays' differ from it
(none should) and whether they equal ``--committed`` (the repo's
``results/bench_results.json``, made at 0.05).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m benchmarks.run --scale 0.05 \
        --ttf 1.0 --out results/fresh/paper_0.05.json
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/port_paper_reference.py \
        --scale 0.05 --ttf 1.0 --samples 16 \
        --bench results/fresh/paper_0.05.json
    (and --scale 0.35 --ttf 1.0 0.5 --samples 8 with its own --bench)
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

import port_paper  # noqa: E402
from repro_torch.workflow import paper  # noqa: E402

# the Sizey jobs' port_tolerance.py method and SizeyConfig overrides
TOLERANCE_ARGS = {"sizey": ("sizey", ()),
                  "sizey_incremental": ("sizey", ("incremental=True",)),
                  "sizey_argmax": ("sizey", ("strategy=argmax",)),
                  "sizey_temporal": ("sizey_temporal", ())}


def tolerance_run(job, samples: int, scratch: pathlib.Path) -> dict:
    """``tools/port_tolerance.py`` on one Sizey job; its JSON."""
    wf, scale, name, ttf, alpha = job
    method, config = TOLERANCE_ARGS[name]
    if alpha is not None:
        config += (f"alpha={alpha}",)
    stem = paper.job_key(*job).replace("/", "_")
    out = scratch / f"{stem}.json"
    cmd = [sys.executable, str(ROOT / "tools" / "port_tolerance.py"),
           "--workflow", wf, "--scale", str(scale), "--method", method,
           "--ttf", str(ttf), "--samples", str(samples), "--log-pool",
           paper.FIG12_POOL[0], "--json", str(out)]
    for c in config:
        cmd += ["--config", c]
    with open(scratch / f"{stem}.log", "w") as log:
        subprocess.run(cmd, check=True, stdout=log, stderr=subprocess.STDOUT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                            "JAX_PLATFORMS": "cpu"})
    return json.loads(out.read_text())


def exact_run(job) -> dict:
    """A numpy baseline or KS+ through the reference."""
    from repro.baselines import make_method
    from repro.workflow import generate_workflow, simulate
    wf, scale, name, ttf, _alpha = job
    method = make_method(name, ttf=ttf)
    res = simulate(generate_workflow(wf, scale=scale), method, ttf=ttf)
    return paper.summarize(res, method)


def limits_from(samples: list, held) -> dict:
    """Twice the largest difference of a move's leaf from the unmoved
    one, per held leaf of the unmoved figures."""
    base = port_paper.leaves(samples[0])
    moves = [port_paper.leaves(s) for s in samples[1:]]
    return {p: 2 * max((abs(m[p] - v) for m in moves), default=0.0)
            for p, v in base.items() if held(p)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, required=True)
    ap.add_argument("--ttf", type=float, nargs="+", default=[1.0, 0.5])
    ap.add_argument("--extra", default="sizey_temporal,ks_plus")
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--procs", type=int, default=7)
    ap.add_argument("--bench", required=True,
                    help="benchmarks.run's output at this scale and ttf")
    ap.add_argument("--committed", default=str(ROOT / "results" /
                                                 "bench_results.json"))
    ap.add_argument("--scratch", default=str(ROOT / "results" / "fresh" /
                                               "tolerance"))
    ap.add_argument("--out", default=str(ROOT / "tools" /
                                         "port_paper_reference.json"))
    args = ap.parse_args()
    t0 = time.perf_counter()
    extra = tuple(e for e in args.extra.split(",") if e)
    ttfs = tuple(args.ttf)
    jobs = paper.jobs(args.scale, ttfs, extra)
    scratch = pathlib.Path(args.scratch) / str(args.scale)
    scratch.mkdir(parents=True, exist_ok=True)
    sizey = [j for j in jobs if j[2] in paper.SIZEY]
    runs: dict = {}
    with cf.ThreadPoolExecutor(args.procs) as pool:
        futs = {pool.submit(tolerance_run, j, args.samples, scratch): j
                for j in sizey}
        for j in jobs:
            if j[2] not in paper.SIZEY:
                runs[paper.job_key(*j)] = exact_run(j)
        for fut in cf.as_completed(futs):
            j = futs[fut]
            runs[paper.job_key(*j)] = fut.result()
            print(f"# tolerance {paper.job_key(*j)} done "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)

    def sample(s: int) -> dict:
        return {k: (r if "base" not in r else
                    r["base"] if s == 0 else r["moves"][s - 1])
                for k, r in runs.items()}

    figs = [port_paper.figures(sample(s), args.scale, ttfs, extra)
            for s in range(args.samples + 1)]
    limits = limits_from(figs, port_paper.held)
    job_rows = [{k: {f: r[f] for f in port_paper.JOB_FIGURES}
                 for k, r in sample(s).items()}
                for s in range(args.samples + 1)]
    job_limits = limits_from(job_rows, lambda p: True)
    bench = json.loads(pathlib.Path(args.bench).read_text())
    bench.pop("roofline_cells", None)
    bench.pop("roofline_skipped", None)
    ours = port_paper.leaves(figs[0])
    differ = sorted(p for p, v in port_paper.leaves(bench).items()
                    if port_paper.held(p) and ours.get(p) != v)
    print(f"# held figures where the unmoved replays differ from "
          f"benchmarks.run's output: {differ or 'none'}")
    figures = {**bench, "table2_extra": figs[0]["table2_extra"]} \
        if extra else bench
    committed = json.loads(pathlib.Path(args.committed).read_text())
    same = None
    if committed.get("scale") == args.scale:
        theirs = port_paper.leaves(committed)
        same = sorted(p for p, v in port_paper.leaves(bench).items()
                      if p in theirs and theirs[p] != v
                      and port_paper.held(p))
        print(f"# held figures that differ from {args.committed}: "
              f"{same or 'none'}")
    out_path = pathlib.Path(args.out)
    doc = (json.loads(out_path.read_text()) if out_path.exists()
           else {"paper": port_paper.PAPER, "scales": {}})
    doc["paper"] = port_paper.PAPER
    doc["scales"][str(args.scale)] = {
        "scale": args.scale, "ttf": list(ttfs), "extra": list(extra),
        "samples": args.samples, "figures": figures, "limits": limits,
        "jobs": job_rows[0], "job_limits": job_limits,
        "differs_from_bench": differ,
        "differs_from_committed": same}
    out_path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"# wrote {out_path} ({time.perf_counter() - t0:.0f} s)")
    want = port_paper.leaves(figures)
    for p, tol in sorted(limits.items()):
        if tol:
            print(f"limit {p} {tol!r} (reference {want[p]!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
