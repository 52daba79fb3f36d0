"""The port's prediction-quality telemetry against the reference, on the
CPU: the quality cases of ``tests/test_obs.py`` on the same inputs through
both packages, and the service's scrape.

  * one ``kind="quality"`` row per completed task, in the reference's
    schema, with the reference's rows: keys, strings and integers equal,
    floats within the allocation limit;
  * the rows are reproducible, clock-stamped on the engine, and
    telemetry changes nothing else (a traced run with quality on is
    bitwise one without);
  * on the journal they survive repair as a prefix, and a run killed at
    any tested byte regenerates them bitwise on resume;
  * the service's scrape carries the tenants' gauges, with the
    reference's values.
"""
import asyncio
import os
import re

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.baselines.sizey_method import SizeyMethod as JMethod  # noqa: E402
from repro.obs.quality import read_quality_rows as j_quality  # noqa: E402
from repro.serving.scheduler_service import \
    SchedulerService as JService  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro.workflow import simulate as j_simulate  # noqa: E402
from repro.workflow import simulate_cluster as j_simulate_cluster  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.baselines import SizeyMethod  # noqa: E402
from repro_torch.obs.quality import (QUALITY_FIELDS,  # noqa: E402
                                     read_quality_rows, summarize_pools,
                                     write_quality_csv)
from repro_torch.serving import SchedulerService  # noqa: E402
from repro_torch.workflow import (generate_workflow, simulate,  # noqa: E402
                                  simulate_cluster)
from repro_torch.workflow.journal import Journal  # noqa: E402
from torch_chaos import (assert_results_equal, kill_and_resume,  # noqa: E402
                         kill_at, kill_points, run_journaled)

CAP = 64.0
# quality rows across the packages: the allocation limit of the peak path
# (PERF.md section 2) on every float
ROW_RTOL = 1e-2


def _trace(gen, seed=3, scale=0.02):
    return gen("eager", seed=seed, scale=scale, machine_cap_gb=CAP)


def _port(**kw):
    return SizeyMethod(machine_cap_gb=CAP, device="cpu", **kw)


def _quality_factory(path):
    return _port(persist_path=path, quality=True)


QUALITY_GB = ("offset_gb", "agg_pred_gb", "alloc_gb", "err_gb")


def _match(ref, port):
    """The same rows in the same order: keys, strings, integers, the
    peaks and the clock equal; the GB fields within ``ROW_RTOL`` of the
    row's allocation, the relative error within the same over the peak
    and the RAQ score within ``ROW_RTOL``."""
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert sorted(a) == sorted(b), i
        tol = ROW_RTOL * a["alloc_gb"]
        for k, va in a.items():
            if va is None or isinstance(va, (str, int)):
                assert type(b[k]) is type(va) and b[k] == va, (i, k)
            elif k in QUALITY_GB:
                assert abs(b[k] - va) <= tol, (i, k)
            elif k == "err_frac":
                assert abs(b[k] - va) <= tol / a["peak_gb"], (i, k)
            elif k == "raq":
                assert abs(b[k] - va) <= ROW_RTOL, (i, k)
            else:
                assert b[k] == va, (i, k)


def test_quality_rows_one_per_task_with_schema(tmp_path):
    trace = _trace(generate_workflow, scale=0.06)
    method = _port(quality=True)
    simulate(trace, method)
    rows = read_quality_rows(method.predictor.db)
    assert len(rows) == len(trace.tasks)
    assert [r["seq"] for r in rows] == list(range(len(rows)))
    for r in rows:
        assert set(QUALITY_FIELDS) <= set(r)
        assert r["t_h"] == 0.0         # serial runs have no virtual clock
        assert r["under"] in (0, 1)
        assert r["alloc_gb"] > 0 and r["peak_gb"] > 0
    modeled = [r for r in rows if r["raq"] is not None]
    assert modeled, "no model-sourced decisions in the whole run"
    for r in modeled:
        assert r["model"] and r["agg_pred_gb"] is not None
    summary = summarize_pools(rows)
    assert sum(s["n"] for s in summary.values()) == len(rows)
    jm = JMethod(machine_cap_gb=CAP, quality=True)
    j_simulate(_trace(j_generate, scale=0.06), jm)
    _match(j_quality(jm.predictor.db), rows)
    path = tmp_path / "q.csv"
    write_quality_csv(rows, path)
    with open(path) as fh:
        assert fh.readline().strip() == ",".join(QUALITY_FIELDS)


def test_quality_rows_deterministic_and_clock_stamped():
    def run():
        m = _port(quality=True)
        simulate_cluster(_trace(generate_workflow), m, n_nodes=4)
        return read_quality_rows(m.predictor.db)

    a, b = run(), run()
    assert a == b                      # bitwise reproducible
    assert any(r["t_h"] > 0.0 for r in a)   # virtual-clock stamped
    jm = JMethod(machine_cap_gb=CAP, quality=True)
    j_simulate_cluster(_trace(j_generate), jm, n_nodes=4)
    ref = j_quality(jm.predictor.db)
    _match(ref, a)
    assert [r["t_h"] for r in a] == [r["t_h"] for r in ref]


def test_tracing_is_bitwise_side_effect_free():
    trace = _trace(generate_workflow)
    res_off = simulate_cluster(trace, _port(), n_nodes=4)
    with obs.tracing() as col:
        res_on = simulate_cluster(trace, _port(quality=True), n_nodes=4)
    assert_results_equal(res_off, res_on)
    assert col.span_counts["engine/complete_wave"] >= 1


def test_quality_off_by_default_emits_nothing():
    method = _port()
    simulate(_trace(generate_workflow), method)
    assert read_quality_rows(method.predictor.db) == []


def test_quality_rows_survive_journal_repair(tmp_path):
    """A crash mid-journal leaves a byte prefix; after repair the surviving
    quality rows are exactly a prefix of the full stream."""
    trace = _trace(generate_workflow)
    path = str(tmp_path / "run.jsonl")
    run_journaled(trace, _quality_factory, path, n_nodes=4)
    base = read_quality_rows(path)
    assert base
    cut_path = kill_at(path, int(os.path.getsize(path) * 0.6),
                       str(tmp_path / "cut.jsonl"))
    Journal.repair(cut_path)
    got = read_quality_rows(cut_path)
    assert len(got) < len(base)
    assert got == base[:len(got)]


@pytest.fixture(scope="module")
def traced_chaos(tmp_path_factory):
    """``tests/chaos.py --traced``'s run on the port: a journaled,
    crashy, straggling run with tracing on and quality rows emitted."""
    trace = _trace(generate_workflow, seed=0, scale=0.04)
    kw = dict(n_nodes=4, fail_rate_per_node_h=0.05, straggler_rate=0.1,
              fail_seed=0)
    path = str(tmp_path_factory.mktemp("traced") / "run.jsonl")
    with obs.tracing():
        baseline = run_journaled(trace, _quality_factory, path, **kw)
    return trace, path, baseline


@pytest.mark.parametrize("point", range(3))
def test_quality_rows_bitwise_across_kill_points(traced_chaos, tmp_path,
                                                 point):
    trace, path, baseline = traced_chaos
    base = read_quality_rows(path)
    assert base, "traced run emitted no quality rows"
    cut = kill_points(path, 3, seed=0)[point]
    scratch = str(tmp_path / "cut.jsonl")
    with obs.tracing():
        res, _eng = kill_and_resume(path, cut, trace, _quality_factory,
                                    scratch=scratch)
    assert_results_equal(baseline, res)
    assert read_quality_rows(scratch) == base


def _scrape(service_cls, method):
    async def main():
        svc = service_cls(max_concurrent=4)
        svc.add_tenant("genomics", weight=2.0)
        async with svc:
            h = await svc.submit("genomics", method[0], method[1],
                                 engine_kwargs={"n_nodes": 4})
            await h
        return svc.stats(), svc.scrape()

    return asyncio.run(main())


def test_service_scrape_exposes_tenant_gauges():
    stats, text = _scrape(SchedulerService,
                          (_trace(generate_workflow), _port()))
    assert "# TYPE scheduler_steps_granted gauge" in text
    assert 'tenant="genomics"' in text
    # the one endpoint also carries the predictor counter families
    assert "predictor_dispatch_total" in text
    j_stats, j_text = _scrape(JService, (_trace(j_generate),
                                         JMethod(machine_cap_gb=CAP)))
    assert stats == j_stats

    def gauges(t):
        return sorted(ln for ln in t.splitlines()
                      if re.match(r'scheduler_\w+\{tenant="genomics"\}', ln))
    assert gauges(text) == gauges(j_text) != []
