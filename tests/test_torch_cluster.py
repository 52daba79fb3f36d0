"""The port's cluster engine, on the CPU.

  * within the port, the 1-node engine on a sequentialized trace is the
    serial replay for every placement policy (a fixed method, a numpy
    baseline and Sizey);
  * across the packages, the numpy baselines and KS+ give a ``SimResult``
    (with its ``cluster`` metrics) equal to the reference's, field for
    field, under every policy, heterogeneous nodes, rack outages,
    stragglers and each failure strategy;
  * Sizey (peak and temporal) on 4 nodes takes the reference's integer
    choices and dispatch counts, with allocations and wastage within the
    tolerances of ``tests/test_torch_slice.py`` and
    ``tests/test_torch_temporal.py``;
  * the indexed placement core is bitwise the reference scan it replaces
    (the cases of ``tests/test_engine_index.py``, on the port's engine).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.baselines import SizeyMethod, make_method  # noqa: E402
from repro_torch.core.predictor import DISPATCH_COUNTS  # noqa: E402
from repro_torch.obs import scoped_counters  # noqa: E402
from repro_torch.workflow import (generate_workflow, simulate,  # noqa: E402
                                  simulate_cluster)
from repro_torch.workflow import cluster as cl  # noqa: E402
from repro_torch.workflow.accounting import MAX_ATTEMPTS  # noqa: E402
from repro_torch.workflow.trace import (TaskInstance,  # noqa: E402
                                       WorkflowTrace)

POLICIES = sorted(cl.PLACEMENT_POLICIES)

# Sizey across the packages (the same limits as the serial replays at
# methylseq 0.05: twice the reference's own spread under 1-ulp moves of
# the MLP's initial weights, PERF.md section 2)
ALLOC_RTOL = 1e-2
WASTAGE_RTOL = 2e-4
T_ALLOC_RTOL = 2.6e-3
T_APART = {"methylation_extract": 3.3e-1}
T_TW_RTOL = 6e-4


def _as_plain(obj):
    """A SimResult as nested plain values (dataclasses of either package
    compare equal when their fields do)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _as_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_as_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _as_plain(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class FixedMethod:
    """Always allocates a fixed amount; doubles on failure."""
    name = "fixed"

    def __init__(self, gb):
        self.gb = gb

    def allocate(self, task):
        return self.gb

    def retry(self, task, attempt, last):
        return last * 2

    def complete(self, task, first_alloc, attempts):
        pass


def _task(tt="A", idx=0, actual=10.0, runtime=1.0, deps=(), arrival=0.0,
          preset=64.0):
    return TaskInstance("wf", tt, "m", 1.0, actual, runtime, preset, 0, idx,
                        arrival_h=arrival, deps=deps)


# ------------------------------------------------- serial equivalence
def _fixed_case():
    tasks = [_task(idx=i, actual=4.0 + 3 * i, runtime=0.5 + 0.25 * i)
             for i in range(6)]   # later tasks OOM the 8 GB allocation
    return (WorkflowTrace("wf", tasks, machine_cap_gb=128.0),
            lambda: FixedMethod(8.0), 0.5)


SERIAL_CASES = {
    "fixed": _fixed_case,
    "witt_lr": lambda: (generate_workflow("iwd", scale=0.1),
                        lambda: make_method("witt_lr"), 1.0),
    "sizey": lambda: (generate_workflow("iwd", scale=0.02),
                      lambda: SizeyMethod(device="cpu"), 1.0),
}


@functools.lru_cache(maxsize=None)
def _serial_case(case):
    trace, make, ttf = SERIAL_CASES[case]()
    return trace, make, ttf, simulate(trace, make(), ttf=ttf)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", sorted(SERIAL_CASES))
def test_one_node_sequential_matches_serial(case, policy):
    trace, make, ttf, serial = _serial_case(case)
    res = simulate_cluster(trace.sequentialized(), make(), ttf=ttf,
                           n_nodes=1, policy=policy)
    assert len(serial.outcomes) == len(res.outcomes)
    for a, b in zip(serial.outcomes, res.outcomes):
        assert a.task.key == b.task.key
        assert (a.first_alloc_gb, a.final_alloc_gb, a.attempts, a.failures,
                a.aborted) == (b.first_alloc_gb, b.final_alloc_gb,
                               b.attempts, b.failures, b.aborted)
        assert a.wastage_gbh == pytest.approx(b.wastage_gbh)
        assert a.finish_h == pytest.approx(b.finish_h)
    assert serial.n_failures == res.n_failures
    assert res.cluster.makespan_h == pytest.approx(serial.total_runtime_h)
    assert res.cluster.policy == policy
    assert res.cluster.n_preemptions == res.cluster.n_node_failures == 0


def test_max_attempts_and_cap_abort_match_serial():
    class Stubborn(FixedMethod):
        def retry(self, task, attempt, last):
            return last

    for make, actual in ((lambda: Stubborn(8.0), 10.0),
                         (lambda: FixedMethod(32.0), 200.0)):
        trace = WorkflowTrace("wf", [_task(actual=actual)],
                              machine_cap_gb=128.0)
        serial = simulate(trace, make())
        res = simulate_cluster(trace.sequentialized(), make(), n_nodes=1)
        assert _as_plain(res.outcomes) == _as_plain(serial.outcomes)
        assert res.outcomes[0].aborted
    assert serial.outcomes[0].failures == 3       # 32, 64, 128 all die
    assert MAX_ATTEMPTS > 3


# ------------------------------------------------- across the packages
def _w(pkg):
    """The package's workflow modules: the reference's or the port's."""
    if pkg == "ref":
        from repro.workflow import cluster, generate_workflow as gen
        from repro.baselines import make_method as mk
        return cluster, gen, mk
    return cl, generate_workflow, make_method


def _policy_case(p):
    return lambda C: ({}, dict(n_nodes=4, node_cap_gb=32.0, policy=p),
                      ("mag", dict(seed=3, scale=0.05,
                                   arrival_rate_per_h=400.0)))


CAPS = {"m16": 16.0, "m32": 32.0, "m64": 64.0}
ENGINE_CASES = {
    **{f"policy-{p}": _policy_case(p) for p in POLICIES},
    "hetero-16-32-64": lambda C: (
        {}, dict(node_specs=C.node_specs_from_caps(list(CAPS.values()),
                                                   n_nodes=6),
                 fail_rate_per_node_h=0.4, repair_h=0.3, fail_seed=5),
        ("rnaseq", dict(seed=1, scale=0.1, machine_caps_gb=CAPS))),
    "rack-outages-stragglers": lambda C: (
        {}, dict(node_specs=C.node_specs_from_racks([[16.0, 32.0, 64.0],
                                                     [16.0, 32.0, 64.0]]),
                 policy="spread", rack_fail_rate_per_h=0.8,
                 rack_repair_h=0.3, straggler_rate=0.15,
                 straggler_factor=3.0, fail_seed=11),
        ("chipseq", dict(seed=2, scale=0.05, arrival_rate_per_h=300.0,
                         machine_caps_gb=CAPS))),
    **{f"crashes-{s}": (lambda s: lambda C: (
        {"failure_strategy": s},
        dict(n_nodes=4, node_cap_gb=16.0, policy="best_fit",
             fail_rate_per_node_h=3.0, repair_h=0.2, fail_seed=9),
        ("iwd", dict(seed=4, scale=0.1, arrival_rate_per_h=600.0))))(s)
       for s in ("retry_same", "retry_scaled", "checkpoint")},
}


def _engine_run(pkg, name, case):
    C, gen, mk = _w(pkg)
    mkw, kw, (wf, gkw) = ENGINE_CASES[case](C)
    trace = gen(wf, **gkw)
    cap = max(t.machine_cap_gb or trace.machine_cap_gb for t in trace.tasks)
    if "node_cap_gb" in kw:
        cap = kw["node_cap_gb"]
    dev = {"device": "cpu"} if pkg == "port" and name == "ks_plus" else {}
    return C.simulate_cluster(trace, mk(name, machine_cap_gb=cap, **mkw,
                                        **dev), **kw)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
@pytest.mark.parametrize("name", ["witt_lr", "ks_plus"])
def test_engine_results_equal_the_reference(name, case):
    pytest.importorskip("jax")
    rj = _engine_run("ref", name, case)
    rt = _engine_run("port", name, case)
    assert len(rt.outcomes) > 0 and rt.cluster.n_waves > 0
    assert _as_plain(rt) == _as_plain(rj)
    if case.startswith("crashes") or case.startswith("hetero"):
        assert rt.cluster.n_node_failures > 0
    if case.startswith("rack"):
        assert rt.cluster.n_rack_failures > 0
        assert rt.cluster.n_straggler_attempts > 0


def _sizey_run(pkg, temporal):
    if pkg == "ref":
        from repro.baselines import SizeyMethod as M
        from repro.core.predictor import DISPATCH_COUNTS as counts
        from repro.workflow import (generate_workflow as gen,
                                    simulate_cluster as sim)
        method = M(temporal_k=4 if temporal else None)
    else:
        counts, gen, sim = DISPATCH_COUNTS, generate_workflow, \
            simulate_cluster
        method = SizeyMethod(temporal_k=4 if temporal else None,
                             device="cpu")
    decisions = []
    predict_batch = method.predictor.predict_batch

    def recording(tasks):
        out = predict_batch(tasks)
        if temporal:
            decisions.extend((s, d.boundaries) for d in out
                             for s in d.seg_decisions)
        else:
            decisions.extend((d, (1.0,)) for d in out)
        return out

    method.predictor.predict_batch = recording
    before = dict(counts)
    res = sim(gen("methylseq", scale=0.05, arrival_rate_per_h=5.0), method,
              n_nodes=4, fail_rate_per_node_h=0.2 if temporal else 0.0,
              fail_seed=7)
    return res, decisions, {k: counts[k] - before.get(k, 0) for k in counts}


@pytest.mark.parametrize("temporal", [False, True],
                         ids=["peak", "temporal"])
def test_sizey_on_four_nodes_matches_reference(temporal):
    """Integer choices, failures, waves and dispatch counts equal; the
    allocations and the (time-integrated) wastage within the stated
    tolerances."""
    pytest.importorskip("jax")
    rj, dj, cj = _sizey_run("ref", temporal)
    rt, dt, ct = _sizey_run("port", temporal)
    assert cj == ct
    assert ct.get("observe_pool", 0) > 0
    assert len(rj.outcomes) == len(rt.outcomes) == 44
    assert [(o.task.key, o.attempts, o.failures, o.interruptions,
             o.aborted) for o in rj.outcomes] == \
        [(o.task.key, o.attempts, o.failures, o.interruptions, o.aborted)
         for o in rt.outcomes]
    for f in ("n_waves", "n_size_calls", "n_node_failures", "n_resizes",
              "n_resize_waves", "n_grow_failures", "n_preemptions"):
        assert getattr(rj.cluster, f) == getattr(rt.cluster, f), f
    assert len(dj) == len(dt)
    worst = {}
    for (a, ba), (b, bb) in zip(dj, dt):
        assert (a.source, ba) == (b.source, bb)
        if a.source == "model":
            assert a.offset_idx == b.offset_idx
            assert int(np.argmax(a.raq)) == int(np.argmax(b.raq))
        pool = a.task_type if temporal and a.task_type in T_APART else None
        worst[pool] = max(worst.get(pool, 0.0), abs(
            b.allocation_gb - a.allocation_gb) / a.allocation_gb)
    tols = ({None: T_ALLOC_RTOL, **T_APART} if temporal
            else {None: ALLOC_RTOL})
    for pool, w in worst.items():
        assert w <= tols[pool], (pool, w)
    w_attr = "temporal_wastage_gbh" if temporal else "wastage_gbh"
    np.testing.assert_allclose(getattr(rt, w_attr), getattr(rj, w_attr),
                               rtol=T_TW_RTOL if temporal else WASTAGE_RTOL)
    if temporal:
        assert rt.cluster.n_node_failures > 0


def test_ready_waves_bound_dispatches():
    """One predict dispatch per pool per wave at most, and fewer than the
    decisions served (the dispatch-count bound of the engine's waves)."""
    trace = generate_workflow("iwd", scale=0.05)
    n_pools = len({(t.task_type, t.machine) for t in trace.tasks})
    with scoped_counters(DISPATCH_COUNTS) as dc:
        r = simulate_cluster(trace, SizeyMethod(device="cpu"), n_nodes=4)
        dispatches, decisions = dc["predict_pool"], dc["decisions"]
    assert len(r.outcomes) == len(trace.tasks)
    assert 0 < dispatches <= r.cluster.n_waves * n_pools
    assert dispatches < decisions
    assert r.cluster.n_size_calls == r.cluster.n_waves


def test_abandon_leaves_no_pending_after_aborted_burst():
    tasks = [_task("A", 0, actual=4.0, runtime=0.1),
             _task("A", 1, actual=200.0, runtime=0.1),
             _task("A", 2, actual=5.0, runtime=0.1)]
    trace = WorkflowTrace("wf", tasks, machine_cap_gb=128.0)
    method = SizeyMethod(device="cpu")
    r = simulate_cluster(trace, method, n_nodes=2)
    assert sum(o.aborted for o in r.outcomes) == 1
    assert method._pending == {}


# ------------------------------------------------- indexed placement core
def _run_index(monkeypatch, use_index, trace, method, **kw):
    orig = cl.ClusterEngine.__init__

    def patched(self, *a, **k):
        orig(self, *a, **k)
        self._use_index = use_index and self._use_index

    monkeypatch.setattr(cl.ClusterEngine, "__init__", patched)
    return simulate_cluster(trace, method, **kw)


def _assert_bitwise(res_a, res_b):
    assert res_a.outcomes == res_b.outcomes
    ca = dataclasses.asdict(res_a.cluster)
    cb = dataclasses.asdict(res_b.cluster)
    # the reference scan does not count its queue-entry visits
    ca.pop("n_scan_entries"), cb.pop("n_scan_entries")
    assert ca == cb


INDEX_CASES = {
    **{f"policy-{p}": (lambda p: lambda: (
        generate_workflow("mag", seed=3, scale=0.05,
                          arrival_rate_per_h=400.0),
        lambda: make_method("witt_percentile", machine_cap_gb=32.0),
        dict(n_nodes=6, node_cap_gb=32.0, policy=p)))(p)
       for p in POLICIES},
    **{f"hetero-failures-{p}": (lambda p: lambda: (
        generate_workflow("rnaseq", seed=1, scale=0.1, machine_caps_gb=CAPS),
        lambda: make_method("tovar_ppm", machine_cap_gb=64.0),
        dict(node_specs=cl.node_specs_from_caps(list(CAPS.values()),
                                                n_nodes=6),
             policy=p, fail_rate_per_node_h=0.4, repair_h=0.3,
             fail_seed=5)))(p)
       for p in ("backfill", "best_fit", "spread")},
    "racks-stragglers": lambda: (
        generate_workflow("chipseq", seed=2, scale=0.05,
                          arrival_rate_per_h=300.0),
        lambda: make_method("witt_percentile", machine_cap_gb=32.0),
        dict(node_specs=cl.node_specs_from_racks([[16.0, 32.0],
                                                  [16.0, 32.0]]),
             policy="spread", rack_fail_rate_per_h=0.5, rack_repair_h=0.4,
             straggler_rate=0.2, straggler_factor=3.0, fail_seed=11)),
    "temporal-resizes": lambda: (
        generate_workflow("eager", seed=0, scale=0.05,
                          curve_shapes=("ramp",)),
        lambda: SizeyMethod(temporal_k=4, machine_cap_gb=64.0,
                            device="cpu"),
        dict(n_nodes=4, node_cap_gb=64.0, policy="backfill")),
    "retry-scaled-crashes": lambda: (
        generate_workflow("iwd", seed=4, scale=0.1,
                          arrival_rate_per_h=600.0),
        lambda: make_method("witt_percentile", machine_cap_gb=16.0,
                            failure_strategy="retry_scaled"),
        dict(n_nodes=4, node_cap_gb=16.0, policy="best_fit",
             fail_rate_per_node_h=0.8, repair_h=0.2, fail_seed=9)),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_indexed_placement_bitwise_equals_reference_scan(monkeypatch, case):
    trace, make, kw = INDEX_CASES[case]()
    _assert_bitwise(_run_index(monkeypatch, True, trace, make(), **kw),
                    _run_index(monkeypatch, False, trace, make(), **kw))


def test_custom_policy_falls_back_to_reference_path():
    calls = []

    def mine(queue, ctx):
        calls.append(len(queue))
        return cl.PLACEMENT_POLICIES["fifo"](queue, ctx)

    cl.PLACEMENT_POLICIES["mine"] = mine
    try:
        trace = generate_workflow("iwd", seed=0, scale=0.03)
        res = simulate_cluster(
            trace, make_method("workflow_presets", machine_cap_gb=16.0),
            n_nodes=2, node_cap_gb=16.0, policy="mine")
        assert calls, "custom policy never invoked"
        assert len(res.outcomes) == len(trace.tasks)
    finally:
        del cl.PLACEMENT_POLICIES["mine"]


def test_work_counters_populated_and_deterministic():
    trace = generate_workflow("mag", seed=0, scale=0.05,
                              arrival_rate_per_h=200.0)
    c1, c2 = (simulate_cluster(
        trace, make_method("workflow_presets", machine_cap_gb=32.0),
        n_nodes=4, node_cap_gb=32.0).cluster for _ in range(2))
    assert c1.n_events > 0 and c1.n_scan_entries > 0
    assert c1.n_events <= c1.n_heap_pushes
    assert (c1.n_events, c1.n_scan_entries, c1.n_heap_pushes) == \
           (c2.n_events, c2.n_scan_entries, c2.n_heap_pushes)


def test_bad_configurations_rejected():
    trace = generate_workflow("iwd", seed=0, scale=0.03)
    with pytest.raises(ValueError, match="unique"):
        simulate_cluster(trace, make_method("workflow_presets"),
                         node_specs=[cl.NodeSpec("n0", 32.0),
                                     cl.NodeSpec("n0", 64.0)])
    with pytest.raises(ValueError, match="placement policy"):
        simulate_cluster(trace, FixedMethod(16.0), policy="sjf")
    assert set(POLICIES) == {"fifo", "backfill", "best_fit", "spread",
                             "preemptive"}


class _E:
    __slots__ = ("seq",)

    def __init__(self, seq):
        self.seq = seq


def test_seq_queue_iterates_in_seq_order_through_churn():
    q = cl._SeqQueue()
    es = [_E(i) for i in range(100)]
    for e in es:
        q.push(e)
    for e in es[10:90]:
        q.discard(e)
    for e in es[20:25]:
        q.requeue(e)
    expect = sorted(es[:10] + es[20:25] + es[90:], key=lambda e: e.seq)
    assert list(q) == expect
    assert len(q) == len(expect)
    assert q[-1] is es[-1] and q[0] is es[0]


def test_seq_queue_requeue_after_compaction_reinserts_in_order():
    q = cl._SeqQueue()
    es = [_E(i) for i in range(40)]
    for e in es:
        q.push(e)
    for e in es[:39]:
        q.discard(e)
    q.compact()
    q.requeue(es[5])
    assert [e.seq for e in q] == [5, 39]
    q.discard(es[5]), q.discard(es[39])
    assert not q and len(q) == 0


# ------------------------------------------------- chip_smoke's phase 13
def test_chip_smoke_cluster_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 13 rehearsed on the CPU at scale 0.05: the
    same code drives (a) and (b), the launch and dispatch checks, (c)'s
    kill/resume with its count of model decisions after each resume and
    (d)'s card-vs-CPU comparison (the CPU against itself here), with the
    kernels' plain versions standing in for the kernels (each call
    counted as its launch would be). The card's reference numbers are for
    scale 1.0, so the spread check only prints here."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as m
    from repro_torch.core.models import knn, mlp
    from repro_torch.core.temporal import segments
    from repro_torch.kernels import KERNEL_LAUNCHES

    monkeypatch.setattr(m, "DEV", "cpu")
    monkeypatch.setattr(m, "CLUSTER_A_SCALE", 0.05)
    monkeypatch.setattr(m, "CLUSTER_SCALE", 0.05)
    monkeypatch.setattr(m, "DUR_SCALE", 0.05)
    monkeypatch.setattr(m, "CLUSTER_ARRIVALS", 5.0)
    monkeypatch.setattr(m, "CLUSTER_FAILS", {"fail_rate_per_node_h": 0.2,
                                             "fail_seed": 7})
    monkeypatch.setattr(m, "DUR_KILLS", 2)
    monkeypatch.setattr(m, "_within_spread", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for module, attr, name in ((mlp, "mlp_predict", "ensemble_mlp"),
                               (knn, "knn_predict", "knn_predict"),
                               (segments, "fit_cuts", "segment_dp")):
        fn = getattr(module, attr)

        def counted(*a, _fn=fn, _name=name, **k):
            KERNEL_LAUNCHES[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, attr, counted)
    out = m.cluster_phase()
    a, b = out["a"], out["b"]
    assert a["disp"]["predict_pool"] >= 1
    assert b["fits"] >= 1 and b["res"].cluster.n_resizes > 0
    assert out["shapes"]["ensemble_mlp"] and out["shapes"]["knn_predict"]
