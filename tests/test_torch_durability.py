"""The port's journal and crash recovery, on the CPU.

  * within the port, a journaled run is bitwise the unjournaled one, and a
    run killed at any tested byte of its journal, repaired and resumed is
    bitwise the uninterrupted run, on the peak path and on the temporal
    path under the ``checkpoint`` strategy with rack outages (the cases of
    ``tests/test_durability.py``);
  * across the packages, a numpy baseline's journal file is byte for byte
    the reference's, and a Sizey run's journal rows match the reference's
    row for row in kinds, keys, steps and integer fields, with floats
    within the allocation tolerance.

The kill/resume helpers are those of ``tests/chaos.py``, on the port's
journal (``tests/torch_chaos.py``): a journal is append-only, so a kill
leaves a byte prefix of the completed run's file, and truncating that file
at a byte offset is the crash.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.baselines import SizeyMethod, make_method  # noqa: E402
from repro_torch.core.provenance import (ProvenanceDB,  # noqa: E402
                                         atomic_rewrite_jsonl,
                                         read_jsonl_lines)
from repro_torch.core.temporal.segments import ReservationPlan  # noqa: E402
from repro_torch.workflow import generate_workflow  # noqa: E402
from repro_torch.workflow.cluster import (_RESIZE, ClusterEngine,  # noqa: E402
                                          node_specs_from_caps,
                                          simulate_cluster)
from repro_torch.workflow.journal import Journal, recover_run  # noqa: E402
from repro_torch.workflow.trace import (TaskInstance,  # noqa: E402
                                       WorkflowTrace)
from torch_chaos import (assert_results_equal, kill_and_resume,  # noqa: E402
                         kill_at, kill_points, rows_match, run_journaled)

CAP = 64.0
SCALE = 0.04
# Sizey's journal rows across the packages: floats within the allocation
# limits of PERF.md section 2 at methylseq 0.05, 1e-2 on the peak path and
# the temporal path's loosest pool limit, 3.3e-1 (methylation_extract,
# whose HPO learning rate flips on rounding noise); on a CPU the rows
# differ by at most 6.8e-7 (peak) and 1.020e-1 (temporal, a model
# prediction in that pool)
ROW_RTOL = {"peak": 1e-2, "temporal": 3.3e-1}


# ------------------------------------------------------------ the runs
def make_peak(path=None):
    return SizeyMethod(machine_cap_gb=CAP, persist_path=path, device="cpu")


def make_temporal_ckpt(path=None):
    return SizeyMethod(machine_cap_gb=CAP, persist_path=path, temporal_k=4,
                       failure_strategy="checkpoint", device="cpu")


FAIL_KW = dict(n_nodes=4, fail_rate_per_node_h=0.05, straggler_rate=0.1)
RACK_KW = dict(policy="backfill", fail_rate_per_node_h=0.04,
               rack_fail_rate_per_h=0.8, rack_repair_h=3.0,
               straggler_rate=0.1)


@pytest.fixture(scope="module")
def peak_run(tmp_path_factory):
    trace = generate_workflow("eager", seed=3, scale=SCALE,
                              machine_cap_gb=CAP)
    path = str(tmp_path_factory.mktemp("chaos_peak") / "run.jsonl")
    baseline = run_journaled(trace, make_peak, path, snapshot_every=8,
                             **FAIL_KW)
    return trace, path, baseline


@pytest.fixture(scope="module")
def temporal_run(tmp_path_factory):
    """In-flight plans, RESIZE events and crash-ownership tokens all end
    up in the snapshots (one after every step)."""
    trace = generate_workflow("eager", seed=5, scale=SCALE,
                              machine_cap_gb=CAP)
    kw = dict(RACK_KW, node_specs=node_specs_from_caps([CAP], n_nodes=4,
                                                       n_racks=2))
    path = str(tmp_path_factory.mktemp("chaos_temporal") / "run.jsonl")
    baseline = run_journaled(trace, make_temporal_ckpt, path,
                             snapshot_every=1, **kw)
    return trace, path, baseline


# ------------------------------------------------ within the port
def test_journaled_run_is_bitwise_unjournaled(peak_run):
    trace, _path, baseline = peak_run
    plain = simulate_cluster(trace, make_peak(), **FAIL_KW)
    assert_results_equal(plain, baseline, allow=())
    assert baseline.cluster.n_node_failures > 0
    assert baseline.cluster.n_recoveries == 0


@pytest.mark.parametrize("point", range(6))
def test_warm_resume_bitwise_at_any_kill_point(peak_run, tmp_path, point):
    trace, path, baseline = peak_run
    cuts = kill_points(path, 6, seed=11)
    res, _eng = kill_and_resume(path, cuts[point % len(cuts)], trace,
                                make_peak,
                                scratch=str(tmp_path / "cut.jsonl"))
    assert_results_equal(baseline, res)
    assert res.cluster.n_recoveries == 1


@pytest.mark.parametrize("point", range(4))
def test_warm_resume_bitwise_temporal_checkpoint(temporal_run, tmp_path,
                                                 point):
    trace, path, baseline = temporal_run
    assert baseline.cluster.n_resizes > 0
    cuts = kill_points(path, 4, seed=7)
    res, _eng = kill_and_resume(path, cuts[point % len(cuts)], trace,
                                make_temporal_ckpt,
                                scratch=str(tmp_path / "cut.jsonl"))
    assert_results_equal(baseline, res)


def test_double_crash_recovery(peak_run, tmp_path):
    trace, path, baseline = peak_run
    scratch = str(tmp_path / "double.jsonl")
    kill_at(path, os.path.getsize(path) // 3, scratch)
    eng = recover_run(scratch, trace, make_peak, snapshot_every=8)
    for _ in range(6):
        if not eng.step():
            break
    with open(scratch, "rb") as f:
        blob = f.read()
    with open(scratch, "wb") as f:   # a second kill, torn mid-line
        f.write(blob[:-11])
    res = recover_run(scratch, trace, make_peak, snapshot_every=8).run()
    assert_results_equal(baseline, res)
    assert res.cluster.n_recoveries == 2


def test_cold_resume_reenters_inflight_through_failure_strategy(
        peak_run, tmp_path):
    trace, path, baseline = peak_run
    scratch = str(tmp_path / "cold.jsonl")
    kill_at(path, (2 * os.path.getsize(path)) // 3, scratch)
    eng = recover_run(scratch, trace, make_peak, resume="cold",
                      snapshot_every=8)
    n_interrupted = sum(1 for e in eng.queue
                        if e.ledger is not None and e.ledger.interruptions)
    res = eng.run()
    assert {o.task.key for o in res.outcomes} == \
        {o.task.key for o in baseline.outcomes}
    assert not any(o.aborted for o in res.outcomes)
    assert res.cluster.n_recoveries == 1
    if n_interrupted:
        assert sum(o.interruptions for o in res.outcomes) \
            > sum(o.interruptions for o in baseline.outcomes)


def test_recover_refuses_a_done_run_a_wrong_trace_or_method(peak_run,
                                                            tmp_path):
    trace, path, _baseline = peak_run
    with pytest.raises(ValueError, match="already completed"):
        recover_run(path, trace, make_peak)
    scratch = str(tmp_path / "cut.jsonl")
    kill_at(path, os.path.getsize(path) // 2, scratch)
    other = generate_workflow("eager", seed=99, scale=SCALE,
                              machine_cap_gb=CAP)
    with pytest.raises(ValueError, match="different trace"):
        recover_run(scratch, other, make_peak)
    Journal.repair(scratch)

    def wrong(p):
        return SizeyMethod(machine_cap_gb=CAP, persist_path=p,
                           name="not_the_one", device="cpu")
    with pytest.raises(ValueError, match="written by method"):
        recover_run(scratch, trace, wrong)


def _cut_after_snapshot(path, tmp_path, want_state):
    """Cut the journal right after the first snapshot whose engine state
    satisfies ``want_state``."""
    offset = 0
    with open(path) as f:
        for line in f:
            offset += len(line.encode())
            d = json.loads(line)
            if d.get("kind") == "snap" and want_state(d["state"]):
                return kill_at(path, offset, str(tmp_path / "probe.jsonl"))
    pytest.fail("no snapshot exposed the wanted engine state")


def test_crash_during_inflight_resize_wave(temporal_run, tmp_path):
    trace, path, baseline = temporal_run
    scratch = _cut_after_snapshot(
        path, tmp_path,
        lambda s: any(ev[2] == _RESIZE for ev in s["events"]))
    eng = recover_run(scratch, trace, make_temporal_ckpt, snapshot_every=1)
    assert sum(1 for ev in eng.events if ev[2] == _RESIZE) >= 1
    out = eng.run()
    assert_results_equal(baseline, out)


def test_recovery_with_unrepaired_rack_outage(temporal_run, tmp_path):
    trace, path, baseline = temporal_run
    scratch = _cut_after_snapshot(
        path, tmp_path,
        lambda s: s["down_token"] and any(not n["up"] for n in s["nodes"]))
    eng = recover_run(scratch, trace, make_temporal_ckpt, snapshot_every=1)
    assert eng.down_token and eng.down_due
    down = [n.name for n in eng.nodes if not n.up]
    out = eng.run()
    assert_results_equal(baseline, out)
    assert all(out.cluster.node_downtime_h[n] > 0 for n in down)


def test_resumed_plan_schedules_only_remaining_boundaries():
    curve = ((0.25, 2.0), (0.5, 4.0), (1.0, 6.0))
    task = TaskInstance("wf", "A", "m", 1.0, 6.0, 1.0, 64.0, 0, 0,
                        usage_curve=curve)

    class PlanMethod:
        name = "plan"
        failure_strategy = "checkpoint"
        checkpoint_frac = 0.25

        def allocate(self, t):
            return 7.0

        def plan_for(self, t):
            return ReservationPlan(((0.25, 3.0), (0.5, 5.0), (1.0, 7.0)))

        def retry(self, t, attempt, last):
            return last * 2

        def complete(self, t, first, attempts):
            pass

    eng = ClusterEngine(WorkflowTrace("wf", [task], machine_cap_gb=128.0),
                        PlanMethod(), n_nodes=1, node_cap_gb=128.0)
    eng.step()
    token = next(iter(eng.running))
    assert sum(1 for ev in eng.events if ev[2] == _RESIZE) == 2
    eng.step()                       # the first RESIZE fires at 0.25
    eng._interrupt(token, 0.6)       # retained to the 0.5 boundary
    assert eng.queue[-1].ledger.completed_frac == pytest.approx(0.5)
    eng.step()
    assert [ev for ev in eng.events if ev[2] == _RESIZE] == []
    [(_e, node, _started)] = eng.running.values()
    assert node.held_gb(next(iter(eng.running))) == pytest.approx(7.0)
    [o] = eng.run().outcomes
    assert not o.aborted and o.interruptions == 1


def test_method_state_and_pending_round_trip_through_json():
    """The hooks' blobs survive JSON bitwise, arrays as float32, on both
    paths, ``note_pressure`` rides the method state, and ``note_clock``
    leaves it alone."""
    trace = generate_workflow("methylseq", scale=0.05)
    for temporal in (None, 4):
        m = SizeyMethod(temporal_k=temporal, device="cpu")
        tasks = trace.tasks[:3]
        m.allocate_batch(tasks)
        m.note_interruption(tasks[0], 0.25)
        m.note_pressure(0.75)
        state = json.loads(json.dumps(m.export_state()))
        assert state["pressure"] == 0.75 and state["crash_events"] == 1
        blobs = [json.loads(json.dumps(m.export_pending(t))) for t in tasks]
        m2 = SizeyMethod(temporal_k=temporal, device="cpu")
        m2.restore_state(state)
        assert m2.export_state() == m.export_state()
        for t, blob in zip(tasks, blobs):
            m2.restore_pending(t, blob)
            assert m2._pending[id(t)] == m._pending[id(t)]
            assert m2.export_pending(t) == m.export_pending(t)
        assert m.export_pending(trace.tasks[5]) is None
        # the engine's clock stamps telemetry rows only: no journaled
        # state moves with it
        m.note_clock(2.5)
        assert m.export_state() == m2.export_state()


# ----------------------------------------------- atomic provenance writes
def test_read_jsonl_tolerates_torn_final_line(tmp_path):
    p = str(tmp_path / "t.jsonl")
    rows = [json.dumps({"kind": "aux_t", "i": i}) for i in range(4)]
    with open(p, "w") as f:
        f.write("\n".join(rows) + "\n")
        f.write('{"kind": "aux_t", "i": 4, "tr')
    lines, torn = read_jsonl_lines(p)
    assert torn and lines == rows
    with pytest.warns(RuntimeWarning, match="torn final"):
        db = ProvenanceDB(persist_path=p, device="cpu")
    assert [r["i"] for r in db.aux["aux_t"]] == [0, 1, 2, 3]
    with open(p, "w") as f:
        f.write('{"kind": "aux_t", "i": 0}\nGARBAGE\n{"kind": "aux_t"}\n')
    with pytest.raises(ValueError, match="corrupt"):
        read_jsonl_lines(p)


def test_atomic_rewrite_jsonl(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with open(p, "w") as f:
        f.write("old\n" * 5)
    atomic_rewrite_jsonl(p, ["a", "b"])
    with open(p) as f:
        assert f.read() == "a\nb\n"
    assert os.listdir(str(tmp_path)) == ["t.jsonl"]


def test_history_size_counts_a_pools_rows():
    db = ProvenanceDB(device="cpu")
    assert db.history_size("t", "m") == 0
    from repro_torch.core.provenance import TaskRecord
    for i in range(3):
        db.add(TaskRecord("t", "m", (1.0 + i,), 2.0, 0.5))
    assert db.history_size("t", "m") == 3


def test_journal_repair_truncates_orphans_and_keeps_done_runs(peak_run,
                                                             tmp_path):
    _trace, path, _baseline = peak_run
    with open(path) as f:
        lines = f.read().splitlines()
    kinds = [json.loads(ln).get("kind") for ln in lines]
    cut = next(i + 1 for i in range(1, len(lines))
               if kinds[i] not in ("wal", "snap") and kinds[i - 1] == "wal")
    p2 = str(tmp_path / "orphans.jsonl")
    with open(p2, "w") as f:
        f.write("\n".join(lines[:cut]) + "\n")
    stats = Journal.repair(p2)
    assert stats["repaired"] and stats["dropped_rows"] >= 1
    with open(p2) as f:
        assert json.loads(f.read().splitlines()[-1])["kind"] in ("wal",
                                                                 "snap")
    clean = {"repaired": False, "dropped_rows": 0, "torn_final_line": False}
    assert Journal.repair(p2) == clean
    p3 = str(tmp_path / "done.jsonl")
    kill_at(path, os.path.getsize(path), p3)
    assert Journal.repair(p3) == clean
    with open(p3) as f, open(path) as g:
        assert f.read() == g.read()


# ------------------------------------------------ across the packages
def _journaled_both(tmp_path, make_ref, make_port, trace_kw, engine_kw,
                    db_journal=False):
    from repro.core.provenance import ProvenanceDB as JDB
    from repro.workflow import generate_workflow as j_generate
    from repro.workflow.cluster import ClusterEngine as JEngine
    from repro.workflow.journal import Journal as JJournal
    out = {}
    for pkg, gen, eng, journal_cls, make, db in (
            ("ref", j_generate, JEngine, JJournal, make_ref,
             lambda p: JDB(persist_path=p)),
            ("port", generate_workflow, ClusterEngine, Journal, make_port,
             lambda p: ProvenanceDB(persist_path=p, device="cpu"))):
        path = str(tmp_path / f"{pkg}.jsonl")
        method = make(path)
        journal = (journal_cls(db(path), snapshot_every=8) if db_journal
                   else journal_cls.attach(method, snapshot_every=8))
        res = eng(gen(**trace_kw), method, journal=journal,
                  **engine_kw).run()
        with open(path) as f:
            out[pkg] = (res, f.read())
    return out


def test_numpy_baseline_journal_is_the_references_byte_for_byte(tmp_path):
    pytest.importorskip("jax")
    from repro.baselines import make_method as j_make
    out = _journaled_both(
        tmp_path, lambda p: j_make("witt_lr", machine_cap_gb=CAP),
        lambda p: make_method("witt_lr", machine_cap_gb=CAP),
        dict(name="eager", seed=3, scale=SCALE, machine_cap_gb=CAP),
        dict(FAIL_KW, fail_rate_per_node_h=0.3), db_journal=True)
    assert out["port"][1] == out["ref"][1]
    assert out["port"][0].cluster.n_node_failures > 0
    assert '"rec": "step"' in out["port"][1] and '"snap"' in out["port"][1]


@pytest.mark.parametrize("temporal", [None, 4], ids=["peak", "temporal"])
def test_sizey_journal_rows_match_the_reference(tmp_path, temporal):
    pytest.importorskip("jax")
    from repro.baselines import SizeyMethod as JMethod
    out = _journaled_both(
        tmp_path,
        lambda p: JMethod(persist_path=p, temporal_k=temporal),
        lambda p: SizeyMethod(persist_path=p, temporal_k=temporal,
                              device="cpu"),
        dict(name="methylseq", scale=0.05, arrival_rate_per_h=5.0),
        dict(n_nodes=4, fail_rate_per_node_h=0.2, fail_seed=7))
    rows = {pkg: [json.loads(ln) for ln in text.splitlines()]
            for pkg, (_res, text) in out.items()}
    assert len(rows["port"]) == len(rows["ref"])
    kinds = [r.get("kind") for r in rows["ref"]]
    assert [r.get("kind") for r in rows["port"]] == kinds
    assert {"wal", "snap", None, "log"} <= set(kinds)   # None: a task row
    for i, (a, b) in enumerate(zip(rows["ref"], rows["port"])):
        rows_match(a, b, f"row {i} ({a.get('kind')})",
                    ROW_RTOL["temporal" if temporal else "peak"])
    steps = [r for r in rows["port"] if r.get("rec") == "step"]
    assert [r["step"] for r in steps] == list(range(len(steps)))
    assert any(r["mstate"]["crash_events"] for r in steps)
    sized = [blob for r in steps for _k, _a, blob in r["sized"] if blob]
    assert sized and all(b["kind"] == ("temporal" if temporal else "peak")
                         for b in sized)
