"""Trace schema: physical task instances of black-box task types."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TaskInstance:
    """One physical task execution record (ground truth from the trace)."""
    workflow: str
    task_type: str
    machine: str
    input_size_gb: float
    actual_peak_gb: float     # ground-truth peak memory (known to simulator only)
    runtime_h: float          # successful-run wall time
    user_preset_gb: float     # workflow developer's static estimate
    stage: int                # DAG stage (drives submission order)
    index: int                # instance number within the task type
    arrival_h: float = 0.0    # submission time (event-driven cluster engine)
    # instance-level dependency edges: (task_type, index) keys of upstream
    # instances that must complete before this one may start
    deps: tuple[tuple[str, int], ...] = ()
    # capacity of this instance's machine class on a heterogeneous cluster
    # (None: the trace-wide machine_cap_gb applies — homogeneous setting).
    # Routed into the predictor pools so per-machine pools clamp against
    # the hardware the task actually runs on.
    machine_cap_gb: float | None = None
    # ground-truth memory usage over time: piecewise-constant
    # ((end_frac, gb), ...) over normalized runtime, last end_frac == 1.0,
    # max(gb) == actual_peak_gb. Empty = flat at the peak (the legacy
    # peak-only trace model — every pre-temporal metric is unchanged).
    usage_curve: tuple[tuple[float, float], ...] = ()

    @property
    def key(self) -> tuple[str, int]:
        """Trace-unique instance identifier."""
        return (self.task_type, self.index)

    def usage_at(self, frac: float) -> float:
        """Memory in use at time fraction ``frac`` of the runtime."""
        if not self.usage_curve:
            return self.actual_peak_gb
        from repro_torch.core.temporal.segments import curve_value_at
        return curve_value_at(self.usage_curve, frac)

    def usage_gbh(self, upto_frac: float = 1.0) -> float:
        """Time-integrated memory use (GB·h) over the first ``upto_frac``
        of the runtime — the denominator of time-integrated waste."""
        if not self.usage_curve:
            return self.actual_peak_gb * upto_frac * self.runtime_h
        from repro_torch.core.temporal.segments import curve_integral_frac
        return curve_integral_frac(self.usage_curve, upto_frac) \
            * self.runtime_h

    @property
    def features(self) -> tuple[float, ...]:
        return (self.input_size_gb,)


@dataclasses.dataclass
class WorkflowTrace:
    name: str
    tasks: list[TaskInstance]
    machine_cap_gb: float = 128.0

    @property
    def task_types(self) -> list[str]:
        seen: dict[str, None] = {}
        for t in self.tasks:
            seen.setdefault(t.task_type, None)
        return list(seen)

    def summary(self) -> dict:
        types = self.task_types
        machine_caps: dict[str, float] = {}
        for t in self.tasks:
            if t.machine_cap_gb is not None:
                machine_caps[t.machine] = t.machine_cap_gb
        out = {
            "workflow": self.name,
            "n_task_types": len(types),
            "n_tasks": len(self.tasks),
            # float: the fractional load factor matters when comparing
            # scaled-down traces against Table I
            "avg_instances_per_type": len(self.tasks) / max(len(types), 1),
            "machine_cap_gb": self.machine_cap_gb,
            "machines": sorted({t.machine for t in self.tasks}),
            "has_usage_curves": any(t.usage_curve for t in self.tasks),
        }
        if machine_caps:
            out["machine_caps_gb"] = dict(sorted(machine_caps.items()))
        return out

    def sequentialized(self) -> "WorkflowTrace":
        """A copy whose tasks form one dependency chain in submission order
        (task i depends on task i-1) with arrivals at t=0. On any cluster
        the ready set is then always a single task, so the event engine
        degenerates to the serial replay — the equivalence configuration
        used by tests and benchmarks."""
        chained: list[TaskInstance] = []
        prev: TaskInstance | None = None
        for t in self.tasks:
            chained.append(dataclasses.replace(
                t, arrival_h=0.0, deps=(prev.key,) if prev else ()))
            prev = chained[-1]
        return WorkflowTrace(self.name, chained, self.machine_cap_gb)
