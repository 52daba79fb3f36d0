"""Real-log ingestion: scheduler traces -> :class:`WorkflowTrace`.

Three on-disk formats feed the same trace model:

* **CraneSched-style ``jobs_info`` / ``nodes_info`` logs** (the evaluator
  exemplar): whitespace-separated rows

  ``jobs_info``::

      submit_time priority timelimit predict execution_time node_num req

  ``nodes_info``::

      node_cpu node_mem num

  All times share one unit (``time_unit``, default seconds); ``req`` and
  ``node_mem`` share one memory unit (``mem_unit``, default MB). A job
  spanning ``node_num`` nodes is expanded into ``node_num`` single-node
  instances of ``req / node_num`` each — the engine places memory slots,
  not gang allocations. The ``priority`` column is the only task-class
  signal such logs carry, so it becomes the task-type pool (``p<prio>``),
  and the ``predict`` column (the log's runtime estimate — its only
  per-job covariate) becomes ``input_size_gb``, the feature the online
  predictors regress peaks against.

* **Generic CSV / JSONL** with canonical columns ``task_type``,
  ``submit``, ``runtime``, ``peak`` (+ optional ``req``, ``input``,
  ``machine``); a ``columns=`` mapping renames arbitrary headers onto the
  canonical ones.

Parsing is strict: a malformed or torn row raises :class:`TraceParseError`
carrying ``path:line`` — silently dropping rows would skew every
calibrated statistic downstream.

Arrival times are rebased to the first submission and divided by
``time_compress`` (the exemplar's ``Ratio`` knob): compression squeezes
the *arrival process* to raise offered load while leaving runtimes — and
therefore every wastage integral — untouched.

:func:`calibrate_generators` closes the loop: it fits the
:mod:`repro_torch.workflow.generators` knobs (per-pool peak/runtime bands,
memory~input relationship families, arrival rate and burstiness, preset
inflation) against an ingested log, so synthetic sweeps at any scale stay
anchored to the real workload.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from repro_torch.workflow.cluster import NodeSpec
from repro_torch.workflow.generators import (CURVE_SHAPES, WorkflowSpec,
                                             generate_workflow)
from repro_torch.workflow.trace import TaskInstance, WorkflowTrace

__all__ = [
    "TraceParseError", "TraceCalibration",
    "read_nodes_info", "read_jobs_info",
    "read_csv_trace", "read_jsonl_trace", "load_trace",
    "write_jobs_info", "write_nodes_info",
    "calibrate_generators", "generate_calibrated",
]

# unit -> GB divisor / hours divisor
_MEM_DIV = {"b": 1024.0 ** 3, "kb": 1024.0 ** 2, "mb": 1024.0, "gb": 1.0}
_TIME_DIV = {"s": 3600.0, "m": 60.0, "min": 60.0, "h": 1.0}


class TraceParseError(ValueError):
    """A trace file row failed validation. The message always starts with
    ``<path>:<line>:`` so torn or corrupt rows are diagnosable — rows are
    never silently dropped."""

    def __init__(self, path, line_no: int, msg: str):
        super().__init__(f"{path}:{line_no}: {msg}")
        self.path = str(path)
        self.line_no = line_no


def _mem_to_gb(unit: str) -> float:
    try:
        return _MEM_DIV[unit.lower()]
    except KeyError:
        raise ValueError(f"unknown mem_unit {unit!r} "
                         f"(expected one of {sorted(_MEM_DIV)})") from None


def _time_to_h(unit: str) -> float:
    try:
        return _TIME_DIV[unit.lower()]
    except KeyError:
        raise ValueError(f"unknown time_unit {unit!r} "
                         f"(expected one of {sorted(_TIME_DIV)})") from None


def _data_lines(path):
    """Yield (line_no, stripped_text) for non-blank, non-comment lines."""
    with open(path, encoding="utf-8") as fh:
        for line_no, raw in enumerate(fh, start=1):
            text = raw.strip()
            if not text or text.startswith("#"):
                continue
            yield line_no, text


def _floats(path, line_no: int, fields: list[str],
            names: tuple[str, ...]) -> list[float]:
    if len(fields) != len(names):
        raise TraceParseError(
            path, line_no,
            f"expected {len(names)} fields ({' '.join(names)}), "
            f"got {len(fields)}: {' '.join(fields)!r}")
    out = []
    for name, field in zip(names, fields):
        try:
            val = float(field)
        except ValueError:
            raise TraceParseError(
                path, line_no, f"field {name!r} is not numeric: {field!r}"
            ) from None
        if not math.isfinite(val):
            raise TraceParseError(
                path, line_no, f"field {name!r} is not finite: {field!r}")
        out.append(val)
    return out


# ---------------------------------------------------------------------------
# CraneSched-style jobs_info / nodes_info
# ---------------------------------------------------------------------------

_NODE_COLS = ("node_cpu", "node_mem", "num")
_JOB_COLS = ("submit_time", "priority", "timelimit", "predict",
             "execution_time", "node_num", "req")


def read_nodes_info(path, mem_unit: str = "mb") -> list[NodeSpec]:
    """Parse a ``nodes_info`` table into :class:`NodeSpec` rows.

    Each ``node_cpu node_mem num`` line expands into ``num`` unlabeled
    nodes of ``node_mem`` memory (this repo sizes memory; the CPU column
    is validated but unused). Unlabeled nodes accept any task, matching
    the source logs, which carry no placement constraints.
    """
    div = _mem_to_gb(mem_unit)
    specs: list[NodeSpec] = []
    for line_no, text in _data_lines(path):
        cpu, mem, num = _floats(path, line_no, text.split(), _NODE_COLS)
        if cpu <= 0 or mem <= 0:
            raise TraceParseError(
                path, line_no, f"node_cpu/node_mem must be > 0, "
                f"got {cpu:g}/{mem:g}")
        if num < 1 or num != int(num):
            raise TraceParseError(
                path, line_no, f"num must be a positive integer, got {num:g}")
        cap_gb = mem / div
        for _ in range(int(num)):
            specs.append(NodeSpec(name=f"n{len(specs):04d}", cap_gb=cap_gb))
    if not specs:
        raise TraceParseError(path, 0, "no node rows found")
    return specs


def read_jobs_info(path, mem_unit: str = "mb", time_unit: str = "s",
                   time_compress: float = 1.0, workflow: str | None = None,
                   peak_frac: float = 1.0,
                   machine_cap_gb: float | None = None) -> WorkflowTrace:
    """Parse a CraneSched-style ``jobs_info`` log into a trace.

    Column mapping (the log carries requests, not measured usage):

    * ``priority``       -> task-type pool ``p<priority>`` — the only
      task-class signal in the schema;
    * ``predict``        -> ``input_size_gb`` (the log's runtime estimate,
      in hours) — its only per-job covariate, which the predictors
      regress peaks against;
    * ``req / node_num`` -> per-instance request; ``user_preset_gb`` is
      the request itself and ``actual_peak_gb = peak_frac * request``
      (``peak_frac < 1`` models the usual request inflation when no
      measured peaks exist);
    * ``node_num``       -> the job expands into that many single-node
      instances (``index`` runs per pool), all sharing one submit time;
    * ``submit_time``    -> ``arrival_h``, rebased to the first submission
      and divided by ``time_compress`` (the exemplar's ``Ratio``).

    Row validation mirrors the exemplar's asserts (``execution_time <=
    timelimit``, ``1 <= predict <= timelimit``) and rejects with
    ``path:line`` instead of silently dropping.
    """
    if time_compress <= 0:
        raise ValueError(f"time_compress must be > 0, got {time_compress}")
    if not 0 < peak_frac <= 1.0:
        raise ValueError(f"peak_frac must be in (0, 1], got {peak_frac}")
    mdiv, tdiv = _mem_to_gb(mem_unit), _time_to_h(time_unit)
    name = workflow or Path(path).stem
    rows = []
    for line_no, text in _data_lines(path):
        (submit, prio, limit, predict, exe,
         node_num, req) = _floats(path, line_no, text.split(), _JOB_COLS)
        if exe <= 0:
            raise TraceParseError(
                path, line_no, f"execution_time must be > 0, got {exe:g}")
        if exe > limit:
            raise TraceParseError(
                path, line_no,
                f"execution_time {exe:g} exceeds timelimit {limit:g}")
        if not 1 <= predict <= limit:
            raise TraceParseError(
                path, line_no,
                f"predict must be in [1, timelimit={limit:g}], "
                f"got {predict:g}")
        if node_num < 1 or node_num != int(node_num):
            raise TraceParseError(
                path, line_no,
                f"node_num must be a positive integer, got {node_num:g}")
        if req <= 0:
            raise TraceParseError(path, line_no,
                                  f"req must be > 0, got {req:g}")
        rows.append((submit, int(prio), predict, exe, int(node_num), req))

    if not rows:
        raise TraceParseError(path, 0, "no job rows found")
    rows.sort(key=lambda r: r[0])
    t0 = rows[0][0]
    counters: dict[str, int] = {}
    tasks: list[TaskInstance] = []
    max_req = 0.0
    for submit, prio, predict, exe, node_num, req in rows:
        pool = f"p{prio}"
        req_gb = req / mdiv / node_num
        max_req = max(max_req, req_gb)
        arrival_h = (submit - t0) / tdiv / time_compress
        for _ in range(node_num):
            idx = counters.get(pool, 0)
            counters[pool] = idx + 1
            tasks.append(TaskInstance(
                workflow=name, task_type=pool, machine="any",
                input_size_gb=predict / tdiv,
                actual_peak_gb=req_gb * peak_frac,
                runtime_h=exe / tdiv,
                user_preset_gb=req_gb,
                stage=0, index=idx, arrival_h=arrival_h))
    cap = machine_cap_gb if machine_cap_gb is not None \
        else float(2.0 ** math.ceil(math.log2(max_req))) if max_req > 1 \
        else 1.0
    return WorkflowTrace(name=name, tasks=tasks, machine_cap_gb=cap)


def write_nodes_info(specs: list[NodeSpec], path,
                     mem_unit: str = "mb", cpus: int = 64) -> None:
    """Write nodes as a ``nodes_info`` table (round-trip of
    :func:`read_nodes_info`; consecutive equal capacities collapse into one
    ``num`` row)."""
    div = _mem_to_gb(mem_unit)
    groups: list[list] = []
    for s in specs:
        if groups and groups[-1][0] == s.cap_gb:
            groups[-1][1] += 1
        else:
            groups.append([s.cap_gb, 1])
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(f"# {' '.join(_NODE_COLS)}  (mem in {mem_unit})\n")
        for cap_gb, num in groups:
            fh.write(f"{cpus} {cap_gb * div:g} {num}\n")


def write_jobs_info(trace: WorkflowTrace, path, mem_unit: str = "mb",
                    time_unit: str = "s") -> None:
    """Write a trace as a ``jobs_info`` log (round-trip of
    :func:`read_jobs_info` for single-node pools; also the 100k-task
    bench's export path). Pools named ``p<int>`` keep their priority;
    other pools are numbered by first appearance."""
    mdiv, tdiv = _mem_to_gb(mem_unit), _time_to_h(time_unit)
    prio_of: dict[str, int] = {}
    for t in trace.tasks:
        if t.task_type not in prio_of:
            pt = t.task_type
            if pt.startswith("p") and pt[1:].isdigit():
                prio_of[pt] = int(pt[1:])
            else:
                prio_of[pt] = len(prio_of) + 1
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(f"# {' '.join(_JOB_COLS)}  "
                 f"(req in {mem_unit}, times in {time_unit})\n")
        for t in sorted(trace.tasks, key=lambda t: t.arrival_h):
            exe = max(t.runtime_h * tdiv, 1.0)
            predict = max(t.input_size_gb * tdiv, 1.0)
            limit = max(exe, predict) * 2.0
            fh.write(f"{t.arrival_h * tdiv:.6g} {prio_of[t.task_type]} "
                     f"{limit:.6g} {predict:.6g} {exe:.6g} 1 "
                     f"{t.user_preset_gb * mdiv:.6g}\n")


# ---------------------------------------------------------------------------
# Generic CSV / JSONL schema
# ---------------------------------------------------------------------------

_CANON_REQUIRED = ("task_type", "submit", "runtime", "peak")
_CANON_OPTIONAL = ("req", "input", "machine")


def _canon_row(path, line_no: int, row: dict, columns: dict[str, str] | None,
               mdiv: float, tdiv: float):
    if columns:
        row = {columns.get(k, k): v for k, v in row.items()}
    for col in _CANON_REQUIRED:
        if col not in row or row[col] in ("", None):
            raise TraceParseError(
                path, line_no, f"missing required column {col!r} "
                f"(have: {sorted(row)})")
    vals = {}
    for col in _CANON_REQUIRED + _CANON_OPTIONAL:
        if col in ("task_type", "machine"):
            continue
        if col in row and row[col] not in ("", None):
            try:
                vals[col] = float(row[col])
            except (TypeError, ValueError):
                raise TraceParseError(
                    path, line_no,
                    f"column {col!r} is not numeric: {row[col]!r}") from None
    if vals["runtime"] <= 0:
        raise TraceParseError(
            path, line_no, f"runtime must be > 0, got {vals['runtime']:g}")
    if vals["peak"] <= 0:
        raise TraceParseError(
            path, line_no, f"peak must be > 0, got {vals['peak']:g}")
    peak = vals["peak"] / mdiv
    req = vals.get("req", 0.0) / mdiv
    if req and req < peak:
        raise TraceParseError(
            path, line_no, f"req {req:g} GB below peak {peak:g} GB")
    return (str(row["task_type"]), vals["submit"] / tdiv,
            vals["runtime"] / tdiv, peak, req,
            vals.get("input", 0.0) / mdiv, str(row.get("machine") or "any"))


def _trace_from_canon(name: str, rows: list, time_compress: float,
                      machine_cap_gb: float | None) -> WorkflowTrace:
    rows.sort(key=lambda r: r[1])
    t0 = rows[0][1]
    counters: dict[str, int] = {}
    tasks: list[TaskInstance] = []
    max_gb = 0.0
    for pool, submit, runtime, peak, req, inp, machine in rows:
        idx = counters.get(pool, 0)
        counters[pool] = idx + 1
        preset = req if req else peak * 2.0
        max_gb = max(max_gb, preset)
        tasks.append(TaskInstance(
            workflow=name, task_type=pool, machine=machine,
            input_size_gb=inp if inp else runtime,
            actual_peak_gb=peak, runtime_h=runtime,
            user_preset_gb=preset, stage=0, index=idx,
            arrival_h=(submit - t0) / time_compress))
    cap = machine_cap_gb if machine_cap_gb is not None \
        else float(2.0 ** math.ceil(math.log2(max_gb))) if max_gb > 1 \
        else 1.0
    return WorkflowTrace(name=name, tasks=tasks, machine_cap_gb=cap)


def read_csv_trace(path, mem_unit: str = "gb", time_unit: str = "h",
                   time_compress: float = 1.0,
                   columns: dict[str, str] | None = None,
                   workflow: str | None = None,
                   machine_cap_gb: float | None = None) -> WorkflowTrace:
    """Parse a generic CSV trace. Canonical columns: ``task_type``,
    ``submit``, ``runtime``, ``peak`` (required) + ``req``, ``input``,
    ``machine`` (optional); ``columns={"header": "canonical"}`` renames
    arbitrary headers. ``peak`` is the measured peak (the ground truth the
    synthetic generators fabricate); ``req`` the original request."""
    if time_compress <= 0:
        raise ValueError(f"time_compress must be > 0, got {time_compress}")
    mdiv, tdiv = _mem_to_gb(mem_unit), _time_to_h(time_unit)
    rows = []
    with open(path, newline="", encoding="utf-8") as fh:
        reader = csv.DictReader(fh)
        for line_no, row in enumerate(reader, start=2):
            if None in row or None in row.values():
                raise TraceParseError(
                    path, line_no,
                    f"row has {'extra' if None in row else 'missing'} "
                    f"fields vs header {reader.fieldnames}")
            rows.append(_canon_row(path, line_no, row, columns, mdiv, tdiv))
    if not rows:
        raise TraceParseError(path, 0, "no data rows found")
    return _trace_from_canon(workflow or Path(path).stem, rows,
                             time_compress, machine_cap_gb)


def read_jsonl_trace(path, mem_unit: str = "gb", time_unit: str = "h",
                     time_compress: float = 1.0,
                     columns: dict[str, str] | None = None,
                     workflow: str | None = None,
                     machine_cap_gb: float | None = None) -> WorkflowTrace:
    """Parse a JSONL trace (one object per line, same canonical schema as
    :func:`read_csv_trace`)."""
    if time_compress <= 0:
        raise ValueError(f"time_compress must be > 0, got {time_compress}")
    mdiv, tdiv = _mem_to_gb(mem_unit), _time_to_h(time_unit)
    rows = []
    for line_no, text in _data_lines(path):
        try:
            obj = json.loads(text)
        except json.JSONDecodeError as e:
            raise TraceParseError(path, line_no,
                                  f"invalid JSON: {e}") from None
        if not isinstance(obj, dict):
            raise TraceParseError(
                path, line_no, f"expected a JSON object, got {type(obj).__name__}")
        rows.append(_canon_row(path, line_no, obj, columns, mdiv, tdiv))
    if not rows:
        raise TraceParseError(path, 0, "no data rows found")
    return _trace_from_canon(workflow or Path(path).stem, rows,
                             time_compress, machine_cap_gb)


def load_trace(path, format: str = "auto", **kw) -> WorkflowTrace:
    """Dispatch on ``format`` (or the file suffix when ``auto``):
    ``.csv`` -> :func:`read_csv_trace`, ``.jsonl``/``.json`` ->
    :func:`read_jsonl_trace`, anything else -> :func:`read_jobs_info`."""
    if format == "auto":
        suffix = Path(path).suffix.lower()
        format = {".csv": "csv", ".jsonl": "jsonl",
                  ".json": "jsonl"}.get(suffix, "jobs_info")
    readers = {"csv": read_csv_trace, "jsonl": read_jsonl_trace,
               "jobs_info": read_jobs_info}
    if format not in readers:
        raise ValueError(f"unknown trace format {format!r} "
                         f"(expected one of {sorted(readers)} or 'auto')")
    return readers[format](path, **kw)


# ---------------------------------------------------------------------------
# Generator calibration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceCalibration:
    """Fitted :mod:`generators` knobs for one ingested log — everything
    :func:`generate_calibrated` needs to synthesize look-alike traces at
    any scale/seed."""
    spec: WorkflowSpec
    arrival_rate_per_h: float | None
    arrival_cv: float | None
    fan_in: int
    curve_shapes: tuple[str, ...]
    machine_cap_gb: float
    n_tasks: int                 # ingested size (scale=1.0 reference)


def _classify_rel(xs: np.ndarray, peaks: np.ndarray) -> str:
    """Pick the memory~input relationship family a pool's scatter most
    resembles — the coarse split the generators' families are built
    around: flat pools are ``constant``, strongly correlated ones
    ``linear``, weakly correlated wide-band ones ``clustered``."""
    if len(peaks) < 3 or float(np.std(peaks)) < 1e-9:
        return "constant"
    cv = float(np.std(peaks) / max(np.mean(peaks), 1e-9))
    if float(np.std(xs)) < 1e-9:
        return "constant" if cv < 0.15 else "clustered"
    corr = abs(float(np.corrcoef(xs, peaks)[0, 1]))
    if corr >= 0.55:
        return "linear"
    if cv < 0.15:
        return "constant"
    return "clustered"


def calibrate_generators(trace: WorkflowTrace,
                         name: str | None = None) -> TraceCalibration:
    """Fit the synthetic-generator knobs against an ingested log.

    Per-pool peak/runtime bands, memory~input relationship families,
    preset inflation, arrival rate + burstiness (CV of root inter-arrival
    gaps), fan-in (mean dependency in-degree), and usage-curve shapes are
    all estimated from the trace; the result plugs straight into
    :func:`generate_calibrated` / ``generate_workflow(spec=...)``.

    The fit is deterministic (pure function of the trace), so calibrated
    sweeps are reproducible end-to-end: log -> calibration -> seeded
    synthetic traces.
    """
    if not trace.tasks:
        raise ValueError("cannot calibrate against an empty trace")
    name = name or f"{trace.name}_calibrated"
    pools: dict[str, list[TaskInstance]] = {}
    for t in trace.tasks:
        pools.setdefault(t.task_type, []).append(t)

    bases, spans, rt_means, rels, preset_factors = [], [], [], [], []
    in_lo, in_hi = math.inf, 0.0
    for ts in pools.values():
        peaks = np.array([t.actual_peak_gb for t in ts])
        xs = np.array([t.input_size_gb for t in ts])
        bases.append(float(np.quantile(peaks, 0.1)))
        spans.append(float(peaks.max() - np.quantile(peaks, 0.1)))
        rt_means.append(float(np.mean([t.runtime_h for t in ts])))
        rels.append(_classify_rel(xs, peaks))
        preset_factors.append(
            max(t.user_preset_gb for t in ts) / max(float(peaks.max()), 1e-9))
        in_lo = min(in_lo, float(xs.min()))
        in_hi = max(in_hi, float(xs.max()))

    mean_base = max(float(np.mean(bases)), 0.05)
    spec = WorkflowSpec(
        name=name,
        n_task_types=len(pools),
        avg_instances=max(3, round(len(trace.tasks) / len(pools))),
        mem_base_gb=(max(min(bases), 0.05), max(max(bases), 0.1)),
        mem_span=max(float(np.mean(spans)) / mean_base, 0.1),
        input_gb=(max(in_lo, 0.001), max(in_hi, 0.002)),
        runtime_h=(max(min(rt_means), 1e-4), max(max(rt_means), 2e-4)),
        rel_mix=tuple(rels),
        named_types=tuple(sorted(pools)),
        preset_factor=float(np.median(preset_factors)),
    )

    # arrival process: rate + burstiness of ROOT submissions (tasks with
    # dependency edges arrive via unlocks, not the arrival process)
    roots = sorted(t.arrival_h for t in trace.tasks if not t.deps)
    gaps = np.diff(roots)
    gaps = gaps[gaps > 0]
    arrival_rate = arrival_cv = None
    if len(gaps) >= 2:
        mean_gap = float(gaps.mean())
        arrival_rate = 1.0 / mean_gap
        arrival_cv = max(float(gaps.std() / mean_gap), 0.05)

    deg = [len(t.deps) for t in trace.tasks if t.deps]
    fan_in = max(1, round(float(np.mean(deg)))) if deg else 2

    shapes = tuple(sorted({s for t in trace.tasks
                           for s in (_classify_curve(t),) if s}))
    return TraceCalibration(
        spec=spec, arrival_rate_per_h=arrival_rate, arrival_cv=arrival_cv,
        fan_in=fan_in, curve_shapes=shapes or ("flat",),
        machine_cap_gb=trace.machine_cap_gb, n_tasks=len(trace.tasks))


def _classify_curve(t: TaskInstance) -> str | None:
    """Nearest generator shape family for one measured usage curve
    (None when the trace is peak-only, the usual case for request logs)."""
    if not t.usage_curve or len(t.usage_curve) < 3:
        return None
    levels = np.array([gb for _, gb in t.usage_curve]) / t.actual_peak_gb
    if float(levels.min()) > 0.85:
        return "flat"
    peak_at = int(np.argmax(levels))
    frac_high = float(np.mean(levels > 0.8))
    if frac_high < 0.35:
        return "spike"
    if peak_at >= len(levels) - 2 and float(levels[0]) < 0.6:
        return "ramp"
    return "plateau"


def generate_calibrated(calib: TraceCalibration, seed: int = 0,
                        scale: float = 1.0, **overrides) -> WorkflowTrace:
    """Synthesize a seeded trace from a calibration — the anchored
    counterpart of ``generate_workflow(name)``. ``scale=1.0`` targets the
    ingested log's size; keyword overrides pass through (e.g.
    ``usage_curves=False``, a different ``arrival_rate_per_h``)."""
    kw = dict(
        spec=calib.spec, seed=seed, scale=scale,
        machine_cap_gb=calib.machine_cap_gb,
        arrival_rate_per_h=calib.arrival_rate_per_h,
        arrival_cv=calib.arrival_cv, fan_in=calib.fan_in,
        curve_shapes=calib.curve_shapes,
        usage_curves=calib.curve_shapes != ("flat",),
    )
    kw.update(overrides)
    return generate_workflow(**kw)
