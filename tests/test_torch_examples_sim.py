"""``examples/port_workflow_sim.py`` against ``examples/workflow_sim.py`` on
the CPU: each command runs through the reference (``JAX_PLATFORMS=cpu``)
and through the port (``--device cpu``) as subprocesses, side by side, on
the same arguments; every output file is compared.

Compared by ``chip_smoke.py``'s phase-19 helpers, which hold the card's
runs to the CPU's with the same limits (``PERF.md`` §2):
  * the rows (``example_row_breaches``): the numpy baselines and
    ``ks_plus`` equal in every column but ``wall_s``; each Sizey method's
    integer and string columns equal, its GB·h, hour and utilisation
    columns within the method's path limit of the reference's, relative
    (``EXAMPLE_WASTE``: the peak path 2e-4 and the temporal path 6e-4,
    twice the reference's own spread under 1-ulp moves of the MLP init at
    methylseq 0.05; the risk methods, on 4 nodes at 5 roots an hour,
    twice their own there, ``tools/port_tolerance.py``), plus 0.01 for
    the CSV's rounding of both values to 2 places. One allocation
    difference moves a temporal method's ``wastage_gbh`` and ``tw_gbh``
    by the same GB·h, so both columns take the path's limit;
  * the quality rows (``example_quality_breaches``): keys, strings and
    integers equal; GB fields within the path's per-decision allocation
    limit times the row's ``alloc_gb`` (``EXAMPLE_ALLOC``: 1e-2 peak;
    2.6e-3 temporal, 3.3e-1 in ``methylation_extract``; the risk methods
    2.624e-3 and 8.272e-2, twice their spread), ``err_frac`` within that
    over ``peak_gb``, ``raq`` within the limit;
  * the trace (``example_spans``): span names and counts equal;
  * the wastage overlay (``example_overlay_breaches``): timestamps
    equal, every column within the temporal path's wastage limit, plus
    1e-4 for its rounding.
"""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

ENV = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
       "OMP_NUM_THREADS": "1"}
EXACT = cs.EXAMPLE_EXACT
INT_COLUMNS = ("failures", "n_tasks", "waves", "aborted", "preemptions",
               "node_failures", "interruptions", "resizes", "grow_failures",
               "failure_events", "rack_failures", "stragglers")
QUALITY_INTS = ("seq", "under", "n_obs", "fit_serial", "next_fit_at")
SMALL = ["--scale", "0.05", "--workflows", "methylseq", "--ttf", "1.0",
         "--temporal"]
ENGINE = SMALL + ["--cluster", "4", "--arrival-rate", "5", "--risk"]
INGEST = ["--cluster", "--ttf", "1.0", "--trace", "{traces}/"
          "sample_jobs_info.txt", "--trace-nodes",
          "{traces}/sample_nodes_info.txt", "--time-compress", "10"]


def run_both(ref_args: list[str], port_args: list[str], out: pathlib.Path
             ) -> dict[str, str]:
    """Run the reference's workflow_sim.py and the port's side by side;
    return each one's stdout, failing on a non-zero exit."""
    cmds = {"ref": [sys.executable, "examples/workflow_sim.py", *ref_args],
            "port": [sys.executable, "examples/port_workflow_sim.py",
                     *port_args, "--device", "cpu"]}
    procs = {}
    for side, cmd in cmds.items():
        log = open(out / f"{side}.log", "w")
        procs[side] = (subprocess.Popen(cmd, cwd=REPO, env=ENV, stdout=log,
                                        stderr=subprocess.STDOUT), log)
    outs = {}
    for side, (proc, log) in procs.items():
        rc = proc.wait(timeout=600)
        log.close()
        outs[side] = (out / f"{side}.log").read_text()
        assert rc == 0, f"{side} exited {rc}:\n{outs[side][-3000:]}"
    return outs


def sides(out: pathlib.Path, args: list[str], files: dict[str, str]
          ) -> tuple[list[str], list[str]]:
    """Each side's arguments, ``files`` (flag -> file name) given per side
    under ``out``; ``{traces}`` names each package's sample traces."""
    def one(side, pkg):
        extra = [x for flag, name in files.items()
                 for x in (flag, str(out / f"{side}_{name}"))]
        return [a.replace("{traces}", f"src/{pkg}/data/sample_traces")
                for a in args] + extra
    return one("ref", "repro"), one("port", "repro_torch")


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    out = tmp_path_factory.mktemp("serial")
    ref, port = sides(out, SMALL, {"--out": "rows.csv"})
    logs = run_both(ref, port, out)
    return out, logs


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    out = tmp_path_factory.mktemp("engine")
    ref, port = sides(out, ENGINE, {
        "--out": "rows.csv", "--quality-out": "quality.csv",
        "--trace-out": "trace.json", "--plot-wastage": "overlay"})
    logs = run_both(ref, port, out)
    return out, logs


@pytest.fixture(scope="module")
def ingest(tmp_path_factory):
    out = tmp_path_factory.mktemp("ingest")
    ref, port = sides(out, INGEST, {"--out": "rows.csv"})
    logs = run_both(ref, port, out)
    return out, logs


def check_rows(out: pathlib.Path) -> list[str]:
    """Hold the port's CSV rows to the reference's; returns the methods."""
    ref = cs.read_csv(out / "ref_rows.csv")
    port = cs.read_csv(out / "port_rows.csv")
    assert list(port[0]) == list(ref[0])        # columns and their order
    assert [(r["workflow"], r["method"], r["ttf"]) for r in port] == \
        [(r["workflow"], r["method"], r["ttf"]) for r in ref]
    assert cs.example_row_breaches(port, ref) == []
    return [r["method"] for r in ref]


def printed_rows(log: str) -> list[dict]:
    return [ast.literal_eval(line) for line in log.splitlines()
            if line.startswith("{")]


def test_serial_rows_meet_the_reference(serial):
    out, logs = serial
    methods = check_rows(out)
    assert methods == ["sizey", *EXACT[:5], "sizey_temporal", "ks_plus"]
    # the print(row) lines: the reference's keys in its order, each the
    # port's CSV row
    pr, rr = printed_rows(logs["port"]), printed_rows(logs["ref"])
    assert [list(r) for r in pr] == [list(r) for r in rr]
    assert [{k: str(v) for k, v in r.items()} for r in pr] == \
        cs.read_csv(out / "port_rows.csv")


def test_engine_rows_meet_the_reference(engine):
    out, _ = engine
    methods = check_rows(out)
    assert methods == ["sizey", *EXACT[:5], "sizey_temporal", "ks_plus",
                       "sizey_risk", "sizey_risk_temporal"]
    rows = cs.read_csv(out / "port_rows.csv")
    assert all(set(INT_COLUMNS) <= set(r) for r in rows)
    assert sum(int(r["resizes"]) for r in rows) > 0     # RESIZE events ran


def test_engine_quality_rows_meet_the_reference(engine):
    out, logs = engine
    ref = cs.read_csv(out / "ref_quality.csv")
    port = cs.read_csv(out / "port_quality.csv")
    assert list(port[0]) == list(ref[0]) and len(port) == len(ref) > 0
    assert f"({len(ref)} samples)" in logs["port"]
    assert cs.example_quality_breaches(port, ref) == []
    n_model = sum(want["source"] == "model" for want in ref)
    assert n_model > 0 and all(k in ref[0] for k in QUALITY_INTS)


def test_engine_trace_spans_are_the_reference(engine):
    out, logs = engine
    ref = cs.example_spans(out / "ref_trace.json")
    port = cs.example_spans(out / "port_trace.json")
    assert port == ref
    assert {"engine/sizing_wave", "engine/complete_wave", "observe",
            "boundary_fit"} <= set(ref)
    assert f"({sum(port.values())} spans)" in logs["port"]


def test_engine_wastage_overlay_meets_the_reference(engine):
    out, _ = engine
    assert len(cs.read_csv(out / "ref_overlay.csv")) > 1
    assert cs.example_overlay_breaches(out / "port_overlay.csv",
                                       out / "ref_overlay.csv") == []


def test_ingested_log_rows_meet_the_reference(ingest):
    out, logs = ingest
    methods = check_rows(out)
    assert methods == ["sizey", *EXACT[:5]]
    head = [ln for ln in logs["ref"].splitlines()
            if ln.startswith("ingested ")]
    port_head = [ln.replace("src/repro_torch/", "src/repro/")
                 for ln in logs["port"].splitlines()
                 if ln.startswith("ingested ")]
    assert port_head == head and len(head) == 1
