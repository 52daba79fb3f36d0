"""The paper's evaluation through the port (``repro_torch.workflow.paper``,
``tools/port_paper.py``) against the reference's ``benchmarks/run.py``, on
the CPU, at scale 0.05 on rnaseq (30 task types): the numpy baselines'
table2, fig8c and fig8d entries equal, Sizey's within the 0.05 limits of
``tools/port_paper_reference.json`` (twice the reference's spread under
1-ulp moves of the MLP init), every job's record (fig9's incremental and
fig11's argmax replays among them) within its job limits, fig9's and
fig11's keys and types the reference's; the figure functions on the
reference's own replays equal to the reference's;
``tools/port_tolerance.py``'s ``--config`` reproducing the reference's
configurations; and the harness, the tool and chip_smoke.py free of JAX
and of the JAX package. tests/test_torch_paper_mag.py does
the same on mag (large pools) with fig12.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import benchmarks.run as brun  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro.workflow import simulate as j_simulate  # noqa: E402
from repro_torch.workflow import paper  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
SCALE = 0.05
REFERENCE = json.loads((ROOT / "tools" / "port_paper_reference.json")
                       .read_text())["scales"][str(SCALE)]
BASELINES = tuple(m for m in paper.METHODS if m != "sizey")


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load(ROOT / "tools" / "port_paper.py", "port_paper")


def only(workflow: str):
    """The reference's harness cut to one workflow (its figure functions
    read ``WORKFLOWS`` when called)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(brun, "WORKFLOWS", {workflow: None})
    return mp


def run_both(workflow: str, jobs) -> tuple:
    """The port's Grid over ``jobs`` and the reference's SimGrid, both on
    ``workflow`` alone at SCALE and ttf 1.0."""
    records = {paper.job_key(*j): paper.run_job(j, "cpu", log=None)
               for j in jobs}
    grid = tool.Grid(records, SCALE, (1.0,), workflows=[workflow])
    mp = only(workflow)
    try:
        ref = brun.SimGrid(SCALE, (1.0,)).run()
    finally:
        mp.undo()
    return grid, ref


def reference_tables(ref, workflow: str) -> dict:
    """fig8a, fig8c, fig8d and table2 of the reference's harness."""
    want = {}
    mp = only(workflow)
    try:
        brun.bench_fig8ab(ref, 1.0, want)
        brun.bench_fig8c(ref, want)
        brun.bench_fig8d(ref, want)
        brun.bench_table2(ref, want)
    finally:
        mp.undo()
    return want


def table_figures(grid, ref) -> tuple[dict, dict]:
    """fig8a, fig8c, fig8d and table2 of both packages."""
    got = {}
    tool.fig8ab(grid, 1.0, got)
    tool.fig8c(grid, got)
    tool.fig8d(grid, got)
    tool.table2(grid, got)
    return got, reference_tables(ref, grid.workflows[0])


def assert_baselines_equal(got: dict, want: dict, workflow: str) -> None:
    for m in BASELINES:
        assert got["table2"][workflow][m] == want["table2"][workflow][m], m
        assert got["fig8c"][m] == want["fig8c"][m], m
        assert got["fig8d"][m] == want["fig8d"][m], m
        assert got["fig8a"]["wastage_gbh"][m] == \
            want["fig8a"]["wastage_gbh"][m], m


def assert_sizey_within(got: dict, grid, workflow: str) -> None:
    """Sizey's table2 entry within its limit; its failures, runtime and
    time-integrated wastage within their job limits."""
    path = f"table2/{workflow}/sizey"
    want = REFERENCE["figures"]["table2"][workflow]["sizey"]
    assert abs(got["table2"][workflow]["sizey"] - want) \
        <= REFERENCE["limits"][path], (got["table2"][workflow]["sizey"], want)
    key = paper.job_key(workflow, SCALE, "sizey", 1.0)
    rec = grid.records[key]
    for f in ("n_failures", "total_runtime_h", "temporal_wastage_gbh"):
        assert abs(rec[f] - REFERENCE["jobs"][key][f]) \
            <= REFERENCE["job_limits"][f"{key}/{f}"], (f, rec[f])


def assert_same_keys_and_types(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert type(a[k]) is type(b[k]), (k, type(a[k]), type(b[k]))


@pytest.fixture(scope="module")
def rnaseq():
    jobs = paper.jobs(SCALE, (1.0,), workflows=["rnaseq"])
    # fig10's sweep and fig12's mag run are not read here
    jobs = [j for j in jobs if j[4] is None and j[0] != paper.FIG12_WORKFLOW]
    return run_both("rnaseq", jobs)


def test_numpy_baselines_equal_on_rnaseq(rnaseq):
    got, want = table_figures(*rnaseq)
    assert_baselines_equal(got, want, "rnaseq")


def test_sizey_within_the_reference_limits_on_rnaseq(rnaseq):
    grid, _ref = rnaseq
    got, _want = table_figures(*rnaseq)
    assert_sizey_within(got, grid, "rnaseq")


def test_fig9_and_fig11_keys_and_types_match_the_reference(rnaseq):
    grid, ref = rnaseq
    got, want = {}, {}
    tool.fig9(grid, got)
    tool.fig11(grid, got)
    brun.bench_fig9(SCALE, want)
    mp = only("rnaseq")
    try:
        brun.bench_fig11(ref, want)
    finally:
        mp.undo()
    for name in ("fig9", "fig11"):
        assert_same_keys_and_types(got[name], want[name])
    assert got["fig9"]["full_ms"] > got["fig9"]["incremental_ms"] > 0


def test_figure_functions_equal_the_reference_on_its_own_replays(rnaseq):
    """paper.summarize of the reference's replays through the port's figure
    functions gives the reference's figures bit for bit."""
    _grid, ref = rnaseq
    records = {paper.job_key(wf, SCALE, m, ttf):
               paper.summarize(r, ref.methods_store[(wf, m, ttf)])
               for (wf, m, ttf), r in ref.results.items()}
    grid = tool.Grid(records, SCALE, (1.0,), workflows=["rnaseq"])
    got, want = table_figures(grid, ref)
    assert got == want


def test_every_job_within_its_limits_on_rnaseq(rnaseq):
    """Each replay's wastage, time-integrated wastage, failures and runtime
    within the reference's job limits: the numpy baselines equal, and
    Sizey's full, argmax (rnaseq) and incremental (methylseq) replays
    within twice the reference's spread."""
    grid, _ref = rnaseq
    assert {k.split("/")[1] for k in grid.records} >= {
        "sizey", "sizey_incremental", "sizey_argmax"}
    assert tool.compare_jobs(grid.records, REFERENCE) == []


def test_jobs_share_the_grid_runs():
    """fig9's full retrain, fig10's default alpha and fig12's run at 0.35
    are the grid's own sizey runs; each job runs once."""
    at35 = paper.jobs(0.35, (1.0, 0.5), ("sizey_temporal", "ks_plus"))
    assert len(at35) == len(set(at35)) == 6 * 2 * 6 + 1 + 4 + 6 + 12
    assert ("mag", 0.35, "sizey", 1.0, None) in at35
    at05 = paper.jobs(0.05, (1.0,))
    assert len(at05) == 6 * 6 + 1 + 4 + 6 + 1
    assert ("mag", 0.3, "sizey", 1.0, None) in at05
    with pytest.raises(ValueError):
        paper.jobs(0.05, (0.5,))


def test_compare_jobs_holds_each_job_to_its_limits():
    key = "iwd/sizey_incremental/ttf=1.0/scale=0.05"
    want = {"wastage_gbh": 2.0, "temporal_wastage_gbh": 3.0,
            "n_failures": 4, "total_runtime_h": 5.0}
    ref = {"jobs": {key: want, "iwd/witt_lr/ttf=1.0/scale=0.05": want},
           "job_limits": {f"{key}/wastage_gbh": 0.5,
                          f"{key}/temporal_wastage_gbh": 0.5,
                          f"{key}/n_failures": 2}}
    ok = {key: {**want, "wastage_gbh": 2.4, "n_failures": 6,
                "train_ms_median": 9.0}}
    assert tool.compare_jobs(ok, ref) == []
    bad = {key: {**want, "n_failures": 7, "total_runtime_h": 5.0 + 1e-12},
           "iwd/sizey/ttf=1.0/scale=0.05": want}
    assert [b[0] for b in tool.compare_jobs(bad, ref)] == [
        f"{key}/n_failures", f"{key}/total_runtime_h",
        "iwd/sizey/ttf=1.0/scale=0.05/n_failures",
        "iwd/sizey/ttf=1.0/scale=0.05/temporal_wastage_gbh",
        "iwd/sizey/ttf=1.0/scale=0.05/total_runtime_h",
        "iwd/sizey/ttf=1.0/scale=0.05/wastage_gbh"]


def test_compare_holds_each_figure_to_its_limit():
    ref = {"figures": {"table2": {"iwd": {"sizey": 2.0, "witt_lr": 3.0}},
                       "table2_wins": 1, "fig9": {"full_ms": 5.0},
                       "table2_extra": {"iwd": {"ks_plus": {"n": 1}}}},
           "limits": {"table2/iwd/sizey": 0.5}}
    ok = {"table2": {"iwd": {"sizey": 2.4, "witt_lr": 3.0}},
          "table2_wins": 1, "fig9": {"full_ms": 99.0}}
    assert tool.compare(ok, ref, print=lambda *a: None) == []
    bad = {"table2": {"iwd": {"sizey": 2.6, "witt_lr": 3.0 + 1e-12}},
           "table2_wins": 0, "fig9": {"full_ms": 99.0}}
    assert [b[0] for b in tool.compare(bad, ref, print=lambda *a: None)] \
        == ["table2/iwd/sizey", "table2/iwd/witt_lr", "table2_wins"]


@pytest.mark.parametrize("config,name", [({"incremental": True},
                                          "sizey_incremental"),
                                         ({"strategy": "argmax"},
                                          "sizey_argmax")])
def test_port_tolerance_config_reproduces_the_reference(config, name):
    """A 0-move replay of tools/port_tolerance.py with ``--config`` is the
    reference harness's own run of that configuration, methylseq 0.05."""
    tol = _load(ROOT / "tools" / "port_tolerance.py", "port_tolerance")
    res, _d, _b, _n = tol.replay("methylseq", SCALE, "sizey", config=config)
    method = brun._method(name, 1.0)
    want = j_simulate(j_generate("methylseq", scale=SCALE), method, ttf=1.0)
    assert res.wastage_gbh == want.wastage_gbh
    assert res.n_failures == want.n_failures
    assert res.paper["model_select_counts"] == \
        list(method.predictor.model_select_counts)
    assert tol._config(["incremental=True", "strategy=argmax",
                        "alpha=0.25"]) == {"incremental": True,
                                           "strategy": "argmax",
                                           "alpha": 0.25}


def test_the_harness_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]\n"
        "import repro_torch.workflow.paper\n"
        "import chip_smoke\n"
        "spec = importlib.util.spec_from_file_location('port_paper', "
        f"{str(ROOT / 'tools' / 'port_paper.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               or k == 'repro' or k.startswith('benchmarks')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
