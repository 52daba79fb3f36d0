"""The port's risk-priced sizing on the cluster engine against the
reference, on the CPU: the engine's cases of ``tests/test_risk.py`` on the
same inputs through both packages.

  * the engine's live pressure is bounded and, step for step, within the
    allocation limit of the reference's;
  * the temporal risk path: on the input of the reference's own
    ``test_temporal_risk_composes_and_can_collapse`` the port does what the
    reference does. Every model decision there comes while its pool's
    prequential log holds fewer than ``min_samples`` rows (all roots
    arrive at t = 0, so each pool's model-sized tasks are in flight before
    the first of them completes), so neither package writes a risk row.
    Where rows appear in both packages, every plan collapses under
    ``k_collapse_frac=1e9``, with the reference's rows.

The journal's cases are in ``tests/test_torch_risk_chaos.py``.
"""
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.baselines.sizey_method import SizeyMethod as JMethod  # noqa: E402
from repro.core.risk import RiskConfig as JRiskConfig  # noqa: E402
from repro.obs.risk import read_risk_rows as j_rows  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro.workflow.cluster import ClusterEngine as JEngine  # noqa: E402
from repro_torch.baselines import SizeyMethod  # noqa: E402
from repro_torch.core.risk import RiskConfig  # noqa: E402
from repro_torch.obs.risk import read_risk_rows  # noqa: E402
from repro_torch.workflow import generate_workflow  # noqa: E402
from repro_torch.workflow.cluster import ClusterEngine  # noqa: E402
from torch_chaos import assert_risk_rows_match  # noqa: E402

CAP = 64.0
SCALE = 0.3
CLUSTER_SCALE = 0.15
# the reference's risk chaos cell: crashy, and min_samples low enough that
# the residual logs warm up on a small trace
CHAOS_KW = dict(n_nodes=4, fail_rate_per_node_h=0.1, fail_seed=5)
CHAOS_RISK = dict(min_samples=2, window=64)


def _model_sources(method):
    """Count the decisions the models took, per batched predict."""
    sources = []
    predict_batch = method.predictor.predict_batch

    def recording(tasks):
        out = predict_batch(tasks)
        sources.extend(d.source for d in out)
        return out

    method.predictor.predict_batch = recording
    return sources


def _both(trace_kw, method_kw, risk_kw, engine_kw):
    """One engine run in each package on the same inputs: the results, the
    risk rows, the decision sources and the pools' log lengths at every
    model decision."""
    out = {}
    for pkg, gen, method_cls, risk_cls, engine, rows, dev in (
            ("ref", j_generate, JMethod, JRiskConfig, JEngine, j_rows, {}),
            ("port", generate_workflow, SizeyMethod, RiskConfig,
             ClusterEngine, read_risk_rows, {"device": "cpu"})):
        trace = gen(**trace_kw)
        m = method_cls(machine_cap_gb=CAP, risk=risk_cls(**risk_kw),
                       **method_kw, **dev)
        sources = _model_sources(m)
        logs = []
        decide = m.predictor.predict_batch

        def log_lengths(tasks, m=m, logs=logs, decide=decide):
            out_ = decide(tasks)
            for d in out_:
                if d.source == "model":
                    pool = m.predictor.db.pools.get((d.task_type,
                                                     d.machine))
                    logs.append(int(pool.log_count) if pool else 0)
            return out_

        m.predictor.predict_batch = log_lengths
        res = engine(trace, m, **engine_kw).run()
        out[pkg] = (trace, res, rows(m.predictor.db), sources, logs)
    return out


def test_engine_pressure_is_bounded_and_live():
    seen = {}
    for pkg, gen, method, kw, engine in (
            ("ref", j_generate, JMethod, {}, JEngine),
            ("port", generate_workflow, SizeyMethod, {"device": "cpu"},
             ClusterEngine)):
        trace = gen("eager", seed=3, scale=CLUSTER_SCALE, machine_cap_gb=CAP)
        eng = engine(trace, method(machine_cap_gb=CAP, risk=True, **kw),
                     n_nodes=4)
        assert eng.pressure() == 0.0
        seen[pkg] = []
        while eng.step():
            seen[pkg].append(eng.pressure())
    assert all(0.0 <= p <= 1.0 for p in seen["port"])
    assert max(seen["port"]) > 0.0, "a live run should show nonzero pressure"
    # the same steps; memory pressure moves with the allocations, so each
    # sample is held to the allocation limit (PERF.md section 2)
    assert len(seen["port"]) == len(seen["ref"])
    assert max(abs(a - b) for a, b in zip(seen["port"], seen["ref"])) \
        <= 1e-2


def test_temporal_risk_on_the_reference_tests_input():
    """The reference's ``test_temporal_risk_composes_and_can_collapse``
    input (eager seed 11 at 0.3, every root at t = 0, 4 nodes, k = 4):
    both packages take the same model decisions, each at a pool log below
    ``min_samples``, and write the same rows (none)."""
    out = _both(dict(name="eager", seed=11, scale=SCALE, machine_cap_gb=CAP),
                {"temporal_k": 4}, {"k_collapse_frac": 1e9}, {"n_nodes": 4})
    for pkg in ("ref", "port"):
        trace, res, rows, sources, logs = out[pkg]
        assert len(res.outcomes) == len(trace.tasks)
        assert sources.count("model") == 21 and len(sources) == 451
        assert logs and max(logs) < RiskConfig().min_samples
        assert rows == []
    assert out["port"][3] == out["ref"][3]
    assert out["port"][4] == out["ref"][4]
    assert out["port"][1].n_failures == out["ref"][1].n_failures


def test_temporal_risk_composes_and_can_collapse():
    """Where the logs warm up in both packages (the chaos cell's trace,
    min_samples 2): every banded plan collapses under k_collapse_frac=1e9,
    with the reference's rows and integer choices."""
    out = _both(dict(name="eager", seed=5, scale=CLUSTER_SCALE,
                     machine_cap_gb=CAP),
                {"temporal_k": 4}, dict(CHAOS_RISK, k_collapse_frac=1e9),
                CHAOS_KW)
    trace, res, rows, sources, _logs = out["port"]
    assert rows, "temporal risk run repriced nothing"
    assert all(r["collapsed"] for r in rows)
    assert len(res.outcomes) == len(trace.tasks)
    assert_risk_rows_match(out["ref"][2], rows)
    assert sources == out["ref"][3]
    assert [(o.task.key, o.attempts, o.failures, o.interruptions)
            for o in res.outcomes] == [
        (o.task.key, o.attempts, o.failures, o.interruptions)
        for o in out["ref"][1].outcomes]
