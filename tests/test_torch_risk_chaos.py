"""The risk rows on the port's journal, on the CPU: the durability cases of
``tests/test_risk.py`` at the reference's chaos cell (eager seed 5 at
0.15, 4 nodes, node crashes at 0.1 a node-hour, seed 5,
``RiskConfig(min_samples=2, window=64)``, quality rows on), under
``risk`` and ``risk_auto``.

  * killed at any tested byte, repaired and resumed, a run is bitwise the
    uninterrupted one, and so are its streams of risk and quality rows:
    the re-executed waves regenerate the rows the repair truncated;
  * the uninterrupted run takes the reference's integer choices and writes
    the reference's risk rows, and under ``failure_strategy="auto"`` its
    journal carries the reference's per-task choices.
"""
import json
import os

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.baselines.sizey_method import SizeyMethod as JMethod  # noqa: E402
from repro.core.risk import RiskConfig as JRiskConfig  # noqa: E402
from repro.obs.risk import read_risk_rows as j_rows  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro.workflow.cluster import ClusterEngine as JEngine  # noqa: E402
from repro.workflow.journal import Journal as JJournal  # noqa: E402
from repro_torch.baselines import SizeyMethod  # noqa: E402
from repro_torch.core.risk import RiskConfig  # noqa: E402
from repro_torch.obs.quality import read_quality_rows  # noqa: E402
from repro_torch.obs.risk import read_risk_rows  # noqa: E402
from repro_torch.workflow import generate_workflow  # noqa: E402
from torch_chaos import (assert_results_equal,  # noqa: E402
                         assert_risk_rows_match, kill_and_resume,
                         kill_points, run_journaled)

CAP = 64.0
CLUSTER_SCALE = 0.15
CHAOS_KW = dict(n_nodes=4, fail_rate_per_node_h=0.1, fail_seed=5)
CHAOS_RISK = dict(min_samples=2, window=64)
KILLS = 4


def _factory(auto: bool, ref: bool = False):
    strat = {"failure_strategy": "auto"} if auto else {}
    if ref:
        return lambda path: JMethod(machine_cap_gb=CAP, persist_path=path,
                                    risk=JRiskConfig(**CHAOS_RISK),
                                    quality=True, **strat)
    return lambda path: SizeyMethod(machine_cap_gb=CAP, persist_path=path,
                                    risk=RiskConfig(**CHAOS_RISK),
                                    quality=True, device="cpu", **strat)


def _sized(path):
    """Every sized entry of the journal's step records, in order."""
    out = []
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("rec") == "step":
                out.extend(rec.get("sized", []))
    return out


@pytest.fixture(scope="module", params=["risk", "risk_auto"])
def chaos_run(request, tmp_path_factory):
    """The chaos cell journaled in both packages."""
    auto = request.param == "risk_auto"
    d = tmp_path_factory.mktemp(request.param)
    trace = generate_workflow("eager", seed=5, scale=CLUSTER_SCALE,
                              machine_cap_gb=CAP)
    path = str(d / "port.jsonl")
    base = run_journaled(trace, _factory(auto), path, **CHAOS_KW)
    ref_path = str(d / "ref.jsonl")
    ref_method = _factory(auto, ref=True)(ref_path)
    ref = JEngine(j_generate("eager", seed=5, scale=CLUSTER_SCALE,
                             machine_cap_gb=CAP), ref_method,
                  journal=JJournal.attach(ref_method, snapshot_every=16),
                  **CHAOS_KW).run()
    return auto, trace, path, base, ref_path, ref


@pytest.mark.parametrize("point", range(KILLS))
def test_risk_rows_bitwise_across_kill_points(chaos_run, tmp_path, point):
    auto, trace, path, baseline, _ref_path, _ref = chaos_run
    base_rows = read_risk_rows(path)
    assert base_rows, "crashy risk run emitted no risk rows"
    cut = kill_points(path, KILLS, seed=5)[point]
    scratch = str(tmp_path / "cut.jsonl")
    res, _eng = kill_and_resume(path, cut, trace, _factory(auto),
                                scratch=scratch)
    assert_results_equal(baseline, res)
    got = read_risk_rows(scratch)
    assert got == base_rows, (f"kill@byte {cut}: risk rows diverged "
                              f"({len(got)} vs {len(base_rows)})")
    assert read_quality_rows(scratch) == read_quality_rows(path)


def test_chaos_run_matches_the_reference(chaos_run):
    _auto, _trace, path, base, ref_path, ref = chaos_run
    assert_risk_rows_match(j_rows(ref_path), read_risk_rows(path))
    assert [(o.task.key, o.attempts, o.failures, o.interruptions)
            for o in base.outcomes] == [
        (o.task.key, o.attempts, o.failures, o.interruptions)
        for o in ref.outcomes]
    assert base.cluster.n_node_failures == ref.cluster.n_node_failures > 0
    assert len(read_quality_rows(path)) == len(base.outcomes)


def test_auto_strategy_journal_entries_carry_choices(chaos_run):
    auto, _trace, path, _base, ref_path, _ref = chaos_run
    sized = _sized(path)
    assert sized
    if not auto:
        assert all(len(entry) == 3 for entry in sized)
        return
    for entry in sized:
        assert len(entry) == 5, "auto wave entries must journal choices"
        assert entry[3] in ("retry_same", "retry_scaled", "checkpoint")
        assert 0.0 < entry[4] <= 1.0
    ref = _sized(ref_path)
    assert [(e[0], e[3], e[4]) for e in sized] == \
        [(e[0], e[3], e[4]) for e in ref]
    assert {e[3] for e in sized} - {"retry_same"}, \
        "crash exposure should pick another strategy somewhere"


def test_risk_rows_survive_repair_as_a_prefix(chaos_run, tmp_path):
    """Repair alone keeps a prefix of the risk-row stream: no torn or
    reordered row."""
    from repro_torch.workflow.journal import Journal
    from torch_chaos import kill_at
    _auto, _trace, path, _base, _ref_path, _ref = chaos_run
    base = read_risk_rows(path)
    cut = kill_at(path, int(os.path.getsize(path) * 0.6),
                  str(tmp_path / "cut.jsonl"))
    Journal.repair(cut)
    got = read_risk_rows(cut)
    assert len(got) <= len(base) and got == base[:len(got)]
