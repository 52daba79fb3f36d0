"""The port's trace ingestion against the reference, on the CPU: every
case of ``tests/test_ingest.py`` on the same inputs through both packages.
The module is a numpy copy, so parsed traces, node tables, calibrations,
generated traces and parse errors are the reference's, field for field;
the port reads the sample logs from its own byte-for-byte copies."""
import dataclasses
import json
import math
import pathlib

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.data as J  # noqa: E402
import repro_torch.data as T  # noqa: E402
from repro.baselines import make_method as j_make  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro.workflow import simulate_cluster as j_simulate_cluster  # noqa: E402
from repro.workflow.cluster import NodeSpec as JNodeSpec  # noqa: E402
from repro.workflow.trace import WorkflowTrace as JTrace  # noqa: E402
from repro_torch.baselines import make_method  # noqa: E402
from repro_torch.workflow import generate_workflow, simulate_cluster  # noqa: E402
from repro_torch.workflow.cluster import NodeSpec  # noqa: E402
from repro_torch.workflow.trace import WorkflowTrace  # noqa: E402

REF_TRACES = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
              / "data" / "sample_traces")
SAMPLES = {"jobs": "sample_jobs_info.txt", "nodes": "sample_nodes_info.txt"}


def _paths(kind):
    return REF_TRACES / SAMPLES[kind], T.SAMPLE_TRACES / SAMPLES[kind]


def _same(a, b):
    """Two traces, node lists or calibrations of the two packages equal
    field for field."""
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("kind", ["jobs", "nodes"])
def test_sample_traces_are_byte_copies(kind):
    ref, port = _paths(kind)
    assert port.read_bytes() == ref.read_bytes()


# --------------------------------------------------------- jobs_info parsing
def test_sample_log_parses():
    ref, port = _paths("jobs")
    tr = T.read_jobs_info(port, mem_unit="mb", time_unit="s")
    _same(J.read_jobs_info(ref, mem_unit="mb", time_unit="s"), tr)
    assert len(tr.tasks) >= 80          # multi-node jobs expand
    assert set(tr.task_types) == {"p1", "p2", "p3", "p4"}
    arrivals = [t.arrival_h for t in tr.tasks]
    assert min(arrivals) == 0.0
    assert arrivals == sorted(arrivals)
    for t in tr.tasks:
        assert t.runtime_h > 0 and t.actual_peak_gb > 0
        assert t.user_preset_gb >= t.actual_peak_gb
        assert t.actual_peak_gb <= tr.machine_cap_gb


def test_sample_nodes_parse_and_expand():
    ref, port = _paths("nodes")
    nodes = T.read_nodes_info(port, mem_unit="mb")
    _same(J.read_nodes_info(ref, mem_unit="mb"), nodes)
    assert [n.cap_gb for n in nodes] == [64.0] * 4 + [128.0] * 2
    assert len({n.name for n in nodes}) == len(nodes)


def test_node_num_expands_into_per_slot_instances(tmp_path):
    p = tmp_path / "jobs.txt"
    p.write_text("0 1 100 50 60 4 4096\n")
    tr = T.read_jobs_info(p, mem_unit="mb", time_unit="s")
    _same(J.read_jobs_info(p, mem_unit="mb", time_unit="s"), tr)
    assert len(tr.tasks) == 4
    for t in tr.tasks:
        assert t.user_preset_gb == pytest.approx(1.0)
        assert t.runtime_h == pytest.approx(60 / 3600)


def test_time_compress_divides_arrival_gaps_only():
    ref, port = _paths("jobs")
    base = T.read_jobs_info(port, time_unit="s")
    comp = T.read_jobs_info(port, time_unit="s", time_compress=10.0)
    _same(J.read_jobs_info(ref, time_unit="s", time_compress=10.0), comp)
    for a, b in zip(base.tasks, comp.tasks):
        assert b.arrival_h == pytest.approx(a.arrival_h / 10.0)
        assert b.runtime_h == a.runtime_h


def test_peak_frac_models_request_inflation():
    ref, port = _paths("jobs")
    tr = T.read_jobs_info(port, peak_frac=0.5)
    _same(J.read_jobs_info(ref, peak_frac=0.5), tr)
    for t in tr.tasks:
        assert t.actual_peak_gb == pytest.approx(t.user_preset_gb * 0.5)


@pytest.mark.parametrize("row, msg", [
    ("10 1 100 50 60 1", "expected 7 fields"),
    ("10 1 100 50 sixty 1 1024", "not numeric"),
    ("10 1 100 50 nan 1 1024", "not finite"),
    ("10 1 100 50 0 1 1024", "execution_time must be > 0"),
    ("10 1 100 50 120 1 1024", "exceeds timelimit"),
    ("10 1 100 0.5 60 1 1024", "predict must be in"),
    ("10 1 100 200 60 1 1024", "predict must be in"),
    ("10 1 100 50 60 0 1024", "node_num must be a positive integer"),
    ("10 1 100 50 60 1.5 1024", "node_num must be a positive integer"),
    ("10 1 100 50 60 1 0", "req must be > 0"),
])
def test_malformed_job_rows_rejected_with_line_number(tmp_path, row, msg):
    p = tmp_path / "jobs.txt"
    p.write_text("# header comment\n0 1 100 50 60 1 1024\n" + row + "\n")
    errors = []
    for mod in (J, T):
        with pytest.raises(mod.TraceParseError, match=msg) as ei:
            mod.read_jobs_info(p)
        errors.append(str(ei.value))
    assert f"{p}:3:" in errors[1]
    assert errors[1] == errors[0]


def test_malformed_node_rows_rejected_with_line_number(tmp_path):
    p = tmp_path / "nodes.txt"
    for text, msg, line in (("64 65536 2\n64 65536\n", "expected 3 fields",
                             2),
                            ("64 65536 0\n", "num must be a positive", 1)):
        p.write_text(text)
        errors = []
        for mod in (J, T):
            with pytest.raises(mod.TraceParseError, match=msg) as ei:
                mod.read_nodes_info(p)
            errors.append(str(ei.value))
        assert f"{p}:{line}:" in errors[1] and errors[1] == errors[0]


def test_empty_log_rejected(tmp_path):
    p = tmp_path / "jobs.txt"
    p.write_text("# only a comment\n\n")
    with pytest.raises(T.TraceParseError, match="no job rows"):
        T.read_jobs_info(p)
    with pytest.raises(J.TraceParseError, match="no job rows"):
        J.read_jobs_info(p)


@pytest.mark.parametrize("kw, msg", [
    ({"mem_unit": "tb"}, "unknown mem_unit"),
    ({"time_unit": "d"}, "unknown time_unit"),
    ({"time_compress": 0.0}, "time_compress")],
    ids=["mem_unit", "time_unit", "time_compress"])
def test_bad_units_rejected(kw, msg):
    ref, port = _paths("jobs")
    with pytest.raises(ValueError, match=msg):
        T.read_jobs_info(port, **kw)
    with pytest.raises(ValueError, match=msg):
        J.read_jobs_info(ref, **kw)


# ----------------------------------------------------------- generic schemas
def test_csv_trace_with_column_renames(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("tool,ts,dur,mem_peak,mem_req\n"
                 "align,0,1.5,4.0,8\n"
                 "align,0.5,1.0,3.5,8\n"
                 "sort,1.0,0.25,1.0,2\n")
    cols = {"tool": "task_type", "ts": "submit", "dur": "runtime",
            "mem_peak": "peak", "mem_req": "req"}
    tr = T.read_csv_trace(p, columns=cols)
    _same(J.read_csv_trace(p, columns=cols), tr)
    assert [t.task_type for t in tr.tasks] == ["align", "align", "sort"]
    assert tr.tasks[0].actual_peak_gb == 4.0
    assert tr.tasks[0].user_preset_gb == 8.0


@pytest.mark.parametrize("text, match, line", [
    ("task_type,submit,runtime\nalign,0,1.5\n", "missing required column",
     None),
    ("task_type,submit,runtime,peak\nalign,0,1.5,4.0\nsort,1\n", None, 3)],
    ids=["missing_column", "torn_row"])
def test_csv_missing_column_and_torn_row_rejected(tmp_path, text, match,
                                                  line):
    p = tmp_path / "t.csv"
    p.write_text(text)
    errors = []
    for mod in (J, T):
        with pytest.raises(mod.TraceParseError, match=match) as ei:
            mod.read_csv_trace(p)
        errors.append(str(ei.value))
    assert errors[1] == errors[0]
    if line:
        assert f"{p}:{line}:" in errors[1]


def test_jsonl_trace_and_invalid_json_rejected(tmp_path):
    p = tmp_path / "t.jsonl"
    rows = [{"task_type": "a", "submit": 0, "runtime": 1.0, "peak": 2.0},
            {"task_type": "a", "submit": 1, "runtime": 0.5, "peak": 2.5}]
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    tr = T.read_jsonl_trace(p)
    _same(J.read_jsonl_trace(p), tr)
    assert len(tr.tasks) == 2 and tr.tasks[1].index == 1
    p.write_text('{"task_type": "a", "submit": 0,\n')
    with pytest.raises(T.TraceParseError, match="invalid JSON") as ei:
        T.read_jsonl_trace(p)
    assert f"{p}:1:" in str(ei.value)


def test_load_trace_dispatches_on_suffix(tmp_path):
    c = tmp_path / "t.csv"
    c.write_text("task_type,submit,runtime,peak\na,0,1,2\n")
    _same(J.load_trace(c), T.load_trace(c))
    assert len(T.load_trace(c).tasks) == 1
    with pytest.raises(ValueError, match="unknown trace format"):
        T.load_trace(c, format="xml")


# -------------------------------------------------------------- round-trips
def test_jobs_info_round_trip(tmp_path):
    ref, port = _paths("jobs")
    tr = T.read_jobs_info(port, mem_unit="mb", time_unit="s")
    p, q = tmp_path / "rt.txt", tmp_path / "ref_rt.txt"
    T.write_jobs_info(tr, p, mem_unit="mb", time_unit="s")
    J.write_jobs_info(J.read_jobs_info(ref, mem_unit="mb", time_unit="s"),
                      q, mem_unit="mb", time_unit="s")
    assert p.read_bytes() == q.read_bytes()
    tr2 = T.read_jobs_info(p, mem_unit="mb", time_unit="s")
    assert len(tr2.tasks) == len(tr.tasks)

    def key(t):
        return (t.arrival_h, t.task_type, t.index)

    for a, b in zip(sorted(tr.tasks, key=key), sorted(tr2.tasks, key=key)):
        assert b.task_type == a.task_type
        assert b.actual_peak_gb == pytest.approx(a.actual_peak_gb, rel=1e-5)
        assert b.runtime_h == pytest.approx(a.runtime_h, rel=1e-5)
        assert b.arrival_h == pytest.approx(a.arrival_h, rel=1e-5, abs=1e-9)


def test_nodes_info_round_trip(tmp_path):
    names = (("a", 64.0), ("b", 64.0), ("c", 128.0))
    p, q = tmp_path / "nodes.txt", tmp_path / "ref_nodes.txt"
    T.write_nodes_info([NodeSpec(*n) for n in names], p, mem_unit="mb")
    J.write_nodes_info([JNodeSpec(*n) for n in names], q, mem_unit="mb")
    assert p.read_bytes() == q.read_bytes()
    assert [n.cap_gb for n in T.read_nodes_info(p)] == [64.0, 64.0, 128.0]


# --------------------------------------------------------------- calibration
def test_calibration_is_deterministic_and_generates_reproducibly():
    ref, port = _paths("jobs")
    tr = T.read_jobs_info(port)
    c1 = T.calibrate_generators(tr)
    assert c1 == T.calibrate_generators(tr)
    _same(J.calibrate_generators(J.read_jobs_info(ref)), c1)
    assert isinstance(c1, T.TraceCalibration)
    assert c1.spec.n_task_types == 4
    assert c1.arrival_rate_per_h > 0 and c1.arrival_cv > 0
    g1 = T.generate_calibrated(c1, seed=5)
    assert g1 == T.generate_calibrated(c1, seed=5)
    assert g1 != T.generate_calibrated(c1, seed=6)
    _same(J.generate_calibrated(J.calibrate_generators(J.read_jobs_info(ref)),
                                seed=5), g1)
    assert len(g1.task_types) == 4
    assert 0.5 <= len(g1.tasks) / c1.n_tasks <= 2.0


def test_calibration_matches_trace_statistics():
    _ref, port = _paths("jobs")
    tr = T.read_jobs_info(port)
    cal = T.calibrate_generators(tr)
    peaks = [t.actual_peak_gb for t in tr.tasks]
    lo, hi = cal.spec.mem_base_gb
    assert lo <= hi <= max(peaks)
    rts = [t.runtime_h for t in tr.tasks]
    assert cal.spec.runtime_h[0] >= min(rts) * 0.5
    assert cal.spec.runtime_h[1] <= max(rts) * 2.0
    assert cal.curve_shapes == ("flat",)
    span = max(t.arrival_h for t in tr.tasks)
    n_gaps = len({t.arrival_h for t in tr.tasks}) - 1
    assert cal.arrival_rate_per_h == pytest.approx(n_gaps / span, rel=0.2)
    assert math.isfinite(cal.arrival_cv)


def test_calibration_on_synthetic_trace_recovers_dag_knobs():
    kw = dict(seed=0, scale=0.1, arrival_rate_per_h=50.0, fan_in=3)
    cal = T.calibrate_generators(generate_workflow("mag", **kw))
    _same(J.calibrate_generators(j_generate("mag", **kw)), cal)
    assert cal.fan_in == 3
    assert set(cal.curve_shapes) <= {"ramp", "plateau", "spike", "flat"}
    assert len(cal.curve_shapes) > 1


def test_calibrate_empty_trace_rejected():
    with pytest.raises(ValueError, match="empty trace"):
        T.calibrate_generators(WorkflowTrace("x", []))
    with pytest.raises(ValueError, match="empty trace"):
        J.calibrate_generators(JTrace("x", []))


# --------------------------------------------------- ingest -> replay e2e
def test_ingest_replay_end_to_end_hand_computed(tmp_path):
    p = tmp_path / "jobs.txt"
    p.write_text("0 1 7200 3600 3600 1 4096\n"
                 "1800 2 7200 1800 1800 1 6144\n")
    tr = T.read_jobs_info(p, mem_unit="mb", time_unit="s")
    res = simulate_cluster(tr, make_method("workflow_presets",
                                           machine_cap_gb=8.0),
                           n_nodes=1, node_cap_gb=8.0)
    jres = j_simulate_cluster(J.read_jobs_info(p, mem_unit="mb",
                                               time_unit="s"),
                              j_make("workflow_presets", machine_cap_gb=8.0),
                              n_nodes=1, node_cap_gb=8.0)
    assert dataclasses.asdict(res.cluster) == dataclasses.asdict(jres.cluster)
    c = res.cluster
    assert c.makespan_h == pytest.approx(1.5)
    assert c.mean_queue_delay_h == pytest.approx(0.25)
    assert c.max_queue_delay_h == pytest.approx(0.5)
    assert res.n_failures == 0
    assert c.mean_util == pytest.approx((4.0 + 3.0) / 12.0)


def test_sample_log_replays_on_its_own_node_table():
    """The sample log through Sizey on its own node table: the reference's
    integer choices, waves and events."""
    ref, port = _paths("jobs")
    rn, pn = _paths("nodes")
    tr = T.read_jobs_info(port, time_compress=10.0)
    res = simulate_cluster(tr, make_method("sizey",
                                           machine_cap_gb=tr.machine_cap_gb,
                                           device="cpu"),
                           node_specs=T.read_nodes_info(pn))
    c = res.cluster
    assert len(res.outcomes) == len(tr.tasks)
    assert c.n_aborted == 0
    assert c.makespan_h > max(t.arrival_h for t in tr.tasks)
    assert c.n_events > 0 and c.n_heap_pushes > 0
    jtr = J.read_jobs_info(ref, time_compress=10.0)
    jres = j_simulate_cluster(jtr, j_make("sizey",
                                          machine_cap_gb=jtr.machine_cap_gb),
                              node_specs=J.read_nodes_info(rn))
    assert [(o.task.key, o.attempts, o.failures) for o in res.outcomes] == \
        [(o.task.key, o.attempts, o.failures) for o in jres.outcomes]
    assert (c.n_waves, c.n_events, c.n_size_calls) == (
        jres.cluster.n_waves, jres.cluster.n_events,
        jres.cluster.n_size_calls)
    assert res.wastage_gbh == pytest.approx(jres.wastage_gbh, rel=2e-4)
