"""``examples/port_quality_report.py`` and ``examples/port_quickstart.py``
against the reference's scripts on the CPU, and the port's examples'
imports.

Each pair of scripts runs as subprocesses side by side on the same
input (the reference with ``JAX_PLATFORMS=cpu``, the port with
``--device cpu``). Limits:
  * the quality report, on the reference's ``--quality-out`` CSV and on a
    journal JSONL with its quality rows: ``OUT.csv`` byte for byte and the
    per-pool summary equal (host code over copies of the reference's
    ``obs.quality``);
  * the quickstart at scale 0.05: the workflow line and every baseline's
    line equal; Sizey's wastage, failures and runtime within
    ``tools/port_paper_reference.json``'s job limits for
    ``mag/sizey/ttf=1.0/scale=0.05`` (twice the reference's own spread
    under 16 1-ulp moves of the MLP init), plus 0.01 for the printed
    rounding of both values (``chip_smoke.quickstart_breaches``, with
    which phase 19 holds the card's run to the CPU's);
  * importing any ``examples/port_*.py`` loads neither ``jax`` nor a
    module of the reference package.
"""
from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

ENV = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
       "OMP_NUM_THREADS": "1"}
PORTS = sorted((REPO / "examples").glob("port_*.py"), key=lambda p: p.name)


def run_pair(cmds: dict[str, list[str]], timeout: float = 600
             ) -> dict[str, str]:
    """Run each side's command at once; their stdout, failing on a
    non-zero exit."""
    procs = {side: subprocess.Popen([sys.executable, *cmd], cwd=REPO,
                                    env=ENV, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for side, cmd in cmds.items()}
    outs = {}
    for side, proc in procs.items():
        out, err = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, f"{side}: {err[-3000:]}"
        outs[side] = out
    return outs


@pytest.fixture(scope="module")
def quality_inputs(tmp_path_factory):
    """The reference's --quality-out CSV (methylseq 0.05, serial) and a
    journal JSONL holding a quality=True Sizey run's rows."""
    out = tmp_path_factory.mktemp("quality")
    journal = out / "journal.jsonl"
    code = ("import sys\n"
            "from repro.baselines.sizey_method import SizeyMethod\n"
            "from repro.core import SizeyConfig\n"
            "from repro.workflow import generate_workflow, simulate\n"
            "m = SizeyMethod(SizeyConfig(), ttf=1.0, quality=True, "
            "persist_path=sys.argv[1])\n"
            "simulate(generate_workflow('eager', scale=0.1), m, ttf=1.0)\n")
    run_pair({
        "csv": ["examples/workflow_sim.py", "--scale", "0.05",
                "--workflows", "methylseq", "--ttf", "1.0", "--quality-out",
                str(out / "quality.csv"), "--out", str(out / "rows.csv")],
        "journal": ["-c", code, str(journal)]})
    return out / "quality.csv", journal


@pytest.mark.parametrize("source", ["csv", "journal"])
def test_quality_report_is_the_reference_byte_for_byte(quality_inputs,
                                                        source, tmp_path):
    path = quality_inputs[0 if source == "csv" else 1]
    outs = run_pair({
        "ref": ["examples/quality_report.py", str(path), "--out",
                str(tmp_path / "ref")],
        "port": ["examples/port_quality_report.py", str(path), "--out",
                 str(tmp_path / "port"), "--device", "cpu"]})
    ref_csv = (tmp_path / "ref.csv").read_bytes()
    assert (tmp_path / "port.csv").read_bytes() == ref_csv
    assert ref_csv.count(b"\n") > 20
    # the summary: every line but the two naming the output files
    strip = [ln for ln in outs["ref"].splitlines()
             if not ln.startswith("wrote ")]
    assert [ln for ln in outs["port"].splitlines()
            if not ln.startswith("wrote ")] == strip
    assert any(ln.startswith("pool") for ln in strip)


def test_quality_report_needs_quality_rows(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    proc = subprocess.run(
        [sys.executable, "examples/port_quality_report.py", str(empty),
         "--out", str(tmp_path / "x"), "--device", "cpu"], cwd=REPO,
        env=ENV, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no quality rows" in proc.stderr


def test_quickstart_meets_the_reference():
    outs = run_pair({
        "ref": ["examples/quickstart.py", "--scale", "0.05"],
        "port": ["examples/port_quickstart.py", "--scale", "0.05",
                 "--device", "cpu"]})
    names = [ln.split()[0] for ln in outs["ref"].splitlines()
             if ln.split() and ln.split()[0] in ("sizey", *cs.EXAMPLE_EXACT)]
    assert names == ["sizey", *cs.EXAMPLE_EXACT[:5]]
    assert cs.quickstart_breaches(outs["port"], outs["ref"]) == []
    assert re.search(r"Sizey wastage reduction vs best baseline: -?\d+\.\d%",
                     outs["port"])


@pytest.mark.parametrize("script", PORTS, ids=lambda p: p.name)
def test_port_examples_import_neither_jax_nor_the_reference(script):
    code = ("import runpy, sys\n"
            f"runpy.run_path({str(script)!r}, run_name='example')\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
            "assert not bad, bad\n"
            "assert 'repro_torch' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**ENV, "JAX_PLATFORMS": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_six_port_examples_exist():
    assert [p.name for p in PORTS] == [
        f"port_{n}.py" for n in ("quality_report", "quickstart",
                                 "serve_lm", "sizey_cluster", "train_lm",
                                 "workflow_sim")]
