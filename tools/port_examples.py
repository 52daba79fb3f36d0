"""Run the README's documented example commands through both packages and
compare them.

    # the reference's side, on a CPU with the JAX package (the commands
    # side by side; about a minute at this scale on 8 cores)
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/port_examples.py \
        --make-reference tools/port_examples_reference.json \
        --append "--scale 0.05 --ttf 1.0"
    # the port's side (examples/port_*.py) on the card, against that file
    PYTHONPATH=src python tools/port_examples.py \
        --against tools/port_examples_reference.json \
        --append "--scale 0.05 --ttf 1.0" \
        --out build/port_examples.json

The commands are every ``examples/<script>.py`` line of README.md's
Quickstart (the ``workflow_sim.py`` grid, serial and on the engine, and
its heterogeneous, temporal, risk, rack and ingest runs) and the
quickstart and LM job-sizing loop of the verify notes
(``quickstart.py`` at its default scale 0.2, ``sizey_cluster.py`` on the
port's committed dry-run rows). The port runs each as
``examples/port_<script>.py ... --device DEVICE`` (CUDA by default), with
the port's sample traces for ``--trace``. Every command runs in a process
of its own, all at once (``--procs``). ``--append ARGS`` adds arguments
to every ``workflow_sim.py`` command (a smaller ``--scale`` to try the
tool), ``--only NAME`` runs some of them.

The committed reference file is cut to scale 0.05 and ttf 1.0: at the
documented 0.5 the reference takes 6-10 minutes a command on a CPU, but
the port's host-bound replays on the card need hours for the grid.

Compared as ``tests/test_torch_examples_*.py`` compare: the numpy
baselines' and KS+'s rows equal in every column but ``wall_s`` (a breach:
exit 1), as are the quickstart's baseline lines and sizey_cluster's first
two; a serial command's Sizey rows are held to the paper grid's per-job
limits at its scale (``tools/port_paper_reference.json``: wastage,
failures and runtime); each Sizey method's largest relative difference
of its wastage columns and its integer columns' differences are printed
beside the limits the CPU tests hold at methylseq 0.05 (twice the
reference's own spread there; on the engine at these settings it is not
measured, so they are printed, not held). Each command's wall is printed
beside the reference's (a CPU's), as each command ends.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import pathlib
import re
import shlex
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

EXACT = chip_smoke.EXAMPLE_EXACT
# the CPU tests' and phase 19's limits at methylseq 0.05 (PERF.md §2), by
# method
WASTE_LIMIT = chip_smoke.EXAMPLE_WASTE
WASTE_COLUMNS = ("wastage_gbh", "tw_gbh")
EXTRA = {"quickstart": ["examples/quickstart.py"],
         "sizey_cluster": ["examples/sizey_cluster.py", "--dryrun",
                           "results/dryrun_train_seq_shard.jsonl"]}
BASELINES = EXACT[:5]
PAPER = REPO / "tools" / "port_paper_reference.json"
# a serial row's columns held to the paper grid's per-job limits
PAPER_COLUMNS = {"wastage_gbh": "wastage_gbh", "failures": "n_failures",
                 "runtime_h": "total_runtime_h"}
ROUND = chip_smoke.EXAMPLE_ROUND


def readme_commands() -> dict[str, list[str]]:
    """README.md's ``python examples/<script>.py`` lines (backslash
    continuations joined), named after their flags, then EXTRA."""
    lines = (REPO / "README.md").read_text().splitlines()
    out: dict[str, list[str]] = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        if re.search(r"python examples/\w+\.py", line) \
                and not line.lstrip().startswith(("#", "|")):
            cmd = line
            while cmd.rstrip().endswith("\\") and i + 1 < len(lines):
                i += 1
                cmd = cmd.rstrip()[:-1] + " " + lines[i]
            argv = shlex.split(cmd)
            argv = argv[argv.index("python") + 1:]
            if not os.path.basename(argv[0]).startswith("port_"):
                flags = [a.lstrip("-") for a in argv[1:]
                         if a.startswith("--")]
                name = "_".join(flags[:3]) or "default"
                while name in out:
                    name += "_"
                out[name] = argv
        i += 1
    return {**out, **EXTRA}


def port_argv(argv: list[str], device: str) -> list[str]:
    script = pathlib.PurePosixPath(argv[0])
    port = str(script.with_name("port_" + script.name))
    return [port] + [a.replace("src/repro/", "src/repro_torch/")
                     for a in argv[1:]] + ["--device", device]


def run(argv: list[str], out: pathlib.Path, append: list[str]) -> dict:
    """One command in a process of its own; its wall, stdout and CSV
    rows."""
    out.mkdir(parents=True, exist_ok=True)
    sim = argv[0].endswith("workflow_sim.py")
    cmd = argv + (append if sim else [])
    env = {**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, *cmd,
         *(["--out", str(out / "rows.csv")] if sim else [])],
        cwd=REPO, env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        return {"argv": cmd, "rc": proc.returncode, "wall_s": wall,
                "stderr": proc.stderr[-3000:]}
    rows = []
    if sim:
        with open(out / "rows.csv", newline="") as fh:
            rows = list(csv.DictReader(fh))
    # workflow_sim's rows are its CSV; the other scripts' are their lines
    return {"argv": cmd, "rc": 0, "wall_s": wall, "rows": rows,
            "stdout": "" if sim else proc.stdout}


def run_all(cmds: dict[str, list[str]], base: pathlib.Path, procs: int,
            append: list[str], done=None) -> dict[str, dict]:
    """Every command at once, ``procs`` at a time; ``done(name, run)`` is
    called as each one ends."""
    with ThreadPoolExecutor(procs) as pool:
        futures = {pool.submit(run, argv, base / name, append): name
                   for name, argv in cmds.items()}
        runs = {}
        for f in as_completed(futures):
            runs[futures[f]] = f.result()
            if done is not None:
                done(futures[f], runs[futures[f]])
        return {name: runs[name] for name in cmds}


def _lines(text: str, names) -> dict[str, list[str]]:
    return {ln.split()[0]: ln.split()[1:] for ln in text.splitlines()
            if ln.split() and ln.split()[0] in names}


def paper_limits(argv: list[str]) -> tuple[dict, str]:
    """The paper grid's per-job limits at a serial command's scale
    (twice the reference's own spread over 1-ulp moves of the MLP init)
    and the jobs' scale suffix, where ``tools/port_paper_reference.json``
    has that scale; else ({}, "")."""
    if "--cluster" in argv or "--scale" not in argv:
        return {}, ""
    scale = float(argv[len(argv) - argv[::-1].index("--scale")])
    ref = json.loads(PAPER.read_text())["scales"].get(str(scale))
    return ({}, "") if ref is None else (ref["job_limits"],
                                         f"/scale={scale}")


def compare(name: str, got: dict, want: dict) -> list[str]:
    """Print the comparison of one command; return its breaches."""
    if got["rc"] != 0:
        print(f"{name}: the port exited {got['rc']}: {got['stderr']}")
        return [f"{name}: exit {got['rc']}"]
    breaches = []
    head = (f"{name}: port {got['wall_s']:.1f} s, reference "
            f"{want['wall_s']:.1f} s (a CPU)")
    if name == "quickstart":
        g, w = (_lines(r["stdout"], ("sizey",) + BASELINES)
                for r in (got, want))
        breaches += [f"{name}/{m}" for m in BASELINES if g[m] != w[m]]
        (gw, gf, gr), (ww, wf, wr) = g["sizey"], w["sizey"]
        rel = abs(float(gw) - float(ww)) / float(ww)
        print(f"{head}; baselines equal: {not breaches}; sizey wastage "
              f"{gw} against {ww} GB·h ({rel:.3e}), failures {gf} against "
              f"{wf}, runtime {gr} against {wr} h")
        return breaches
    if name == "sizey_cluster":
        g, w = (r["stdout"].splitlines() for r in (got, want))
        breaches += [f"{name}/{ln.split(':')[0]}" for ln in w[:2]
                     if ln not in g[:2]]
        print(f"{head}; {' | '.join(g[2:4])} against "
              f"{' | '.join(w[2:4])}")
        return breaches
    g_rows, w_rows = got["rows"], want["rows"]
    if [(r["workflow"], r["method"], r["ttf"]) for r in g_rows] != \
            [(r["workflow"], r["method"], r["ttf"]) for r in w_rows] or \
            list(g_rows[0]) != list(w_rows[0]):
        print(f"{head}; the rows differ in their cells or columns")
        return [f"{name}: rows"]
    worst: dict[str, list] = {}
    jobs, scale = paper_limits(got["argv"])
    held, unequal, outside = 0, [], []
    for g, w in zip(g_rows, w_rows):
        m = w["method"]
        if m in EXACT:
            if any(g[k] != v for k, v in w.items() if k != "wall_s"):
                unequal.append(f"{name}/{w['workflow']}/{m}/{w['ttf']}")
            continue
        job = f"{w['workflow']}/{m}/ttf={w['ttf']}{scale}"
        if f"{job}/wastage_gbh" in jobs:
            held += 1
            for col, fig in PAPER_COLUMNS.items():
                lim = jobs[f"{job}/{fig}"]
                if abs(float(g[col]) - float(w[col])) > lim + (
                        ROUND if col != "failures" else 0):
                    outside.append(f"{name}/{job}/{col}: {g[col]} against "
                                   f"{w[col]} (limit {lim:g})")
        rel = max(abs(float(g[k]) - float(w[k])) / max(float(w[k]), 1e-9)
                  for k in WASTE_COLUMNS if k in w)
        ints = sum(g[k] != w[k] for k, v in w.items()
                   if k not in ("wall_s",) and re.fullmatch(r"-?\d+", v))
        cur = worst.setdefault(m, [0.0, "", 0, 0])
        if rel >= cur[0]:
            cur[:2] = [rel, f"{w['workflow']}/ttf={w['ttf']}"]
        cur[2] += ints
        cur[3] += 1
    n_exact = sum(r["method"] in EXACT for r in w_rows)
    print(f"{head}; {len(w_rows)} rows, the {n_exact} numpy-baseline and "
          f"KS+ rows equal: {not unequal}"
          + (f"; {held} Sizey rows held to the paper grid's job limits "
             f"(tools/port_paper_reference.json): {len(outside)} outside"
             if held else ""))
    for line in outside:
        print(f"  outside: {line}")
    breaches += unequal + outside
    for m, (rel, where, ints, n) in worst.items():
        lim = WASTE_LIMIT[m]
        print(f"  {m}: largest wastage difference {rel:.3e} ({where}) "
              f"beside the 0.05 limit {lim:g}"
              f"{' (over)' if rel > lim else ''}; integer columns moved "
              f"in {ints} places over {n} rows")
    return breaches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--make-reference", metavar="JSON",
                    help="run the reference's commands and write them here")
    ap.add_argument("--against", metavar="JSON",
                    help="run the port's commands and compare them with "
                         "this reference file")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (default: cuda)")
    ap.add_argument("--procs", type=int, default=None,
                    help="commands at once (default: all)")
    ap.add_argument("--only", nargs="+", default=None, metavar="NAME")
    ap.add_argument("--append", default="", metavar="ARGS",
                    help="arguments added to every workflow_sim command")
    ap.add_argument("--work", default="build/port_examples",
                    help="directory for the commands' outputs")
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="write the port's runs and the comparison here")
    args = ap.parse_args()
    if bool(args.make_reference) == bool(args.against):
        ap.error("give one of --make-reference and --against")
    cmds = readme_commands()
    if args.only:
        cmds = {k: v for k, v in cmds.items() if k in args.only}
    append = shlex.split(args.append)
    procs = args.procs or len(cmds)
    work = REPO / args.work
    if args.make_reference:
        runs = run_all(cmds, work / "reference", procs, append)
        bad = [k for k, r in runs.items() if r["rc"] != 0]
        for k, r in runs.items():
            print(f"{k}: {' '.join(r['argv'])}: rc {r['rc']}, "
                  f"{r['wall_s']:.1f} s")
        pathlib.Path(args.make_reference).write_text(json.dumps(
            {"append": append, "commands": runs}, indent=0) + "\n")
        return 1 if bad else 0
    ref = json.loads(pathlib.Path(args.against).read_text())
    if ref["append"] != append:
        ap.error(f"the reference file was made with --append "
                 f"{ref['append']!r}")
    cmds = {k: v for k, v in cmds.items() if k in ref["commands"]}
    if args.device.startswith("cuda"):
        # build the kernels once, before the commands' processes start
        sys.path.insert(0, str(REPO / "src"))
        from repro_torch.kernels import _build
        _build.build()
    t0 = time.perf_counter()
    breaches, runs = [], {}

    def done(name, got):
        # each command compared, and the file written, as it ends
        breaches.extend(compare(name, got, ref["commands"][name]))
        runs[name] = got
        sys.stdout.flush()
        if args.out:
            path = pathlib.Path(args.out)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps({
                "wall_s": time.perf_counter() - t0, "device": args.device,
                "runs": runs, "breaches": breaches}))
    run_all({k: port_argv(v, args.device) for k, v in cmds.items()},
            work / "port", procs, append, done)
    print(f"{len(cmds)} commands in {time.perf_counter() - t0:.1f} s on "
          f"{args.device}, {procs} at once; {len(breaches)} breaches "
          f"{breaches}")
    return 1 if breaches else 0


if __name__ == "__main__":
    sys.exit(main())
