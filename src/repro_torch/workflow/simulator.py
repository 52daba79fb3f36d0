"""Online execution simulator (paper §III-A).

Replays a trace in submission order against a sizing method. Semantics:

  * strict memory limits (assumption A3): allocation < actual peak => the
    task is killed;
  * time-to-failure ``ttf``: a killed attempt runs for ttf * runtime before
    dying, burning its whole allocation for that long (nothing useful was
    produced), exactly the paper's simulation parameter;
  * a successful attempt wastes (allocation - actual) * runtime GBh;
  * failed attempts follow the method's own retry policy until the machine
    capacity is reached; if even the capacity cannot fit the task the task
    is aborted (never happens with the shipped generators).

The method interface is minimal so Sizey, all baselines, and the LM-job
sizer share it: allocate / retry / complete. The per-attempt arithmetic
lives in :mod:`repro_torch.workflow.accounting` and is shared with the
event-driven multi-node engine (:mod:`repro.workflow.cluster`) — the
serial replay here is the 1-node special case of the same state machine.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

from repro_torch.workflow.accounting import MAX_ATTEMPTS, AttemptLedger, TaskOutcome
from repro_torch.workflow.trace import TaskInstance, WorkflowTrace

__all__ = ["SizingMethod", "TaskOutcome", "ClusterMetrics", "SimResult",
           "MAX_ATTEMPTS", "simulate"]


class SizingMethod(Protocol):
    name: str

    def allocate(self, task: TaskInstance) -> float:
        """First-attempt allocation in GB."""

    def retry(self, task: TaskInstance, attempt: int,
              last_alloc_gb: float) -> float:
        """Allocation for retry ``attempt`` (1-based) after a failure."""

    def complete(self, task: TaskInstance, first_alloc_gb: float,
                 attempts: int) -> None:
        """Task finished successfully; actual peak may now be observed."""

    # Optional protocol extensions, discovered via hasattr:
    #   allocate_batch(tasks) -> list[float]
    #       size a whole ready wave in one fused dispatch per pool;
    #   plan_for(task) -> ReservationPlan | None
    #       time-segmented reservation for the allocation just returned by
    #       allocate/allocate_batch (temporal methods). A 1-segment plan
    #       (or None) runs on the legacy constant-reservation path;
    #   complete_batch(items: list[tuple[task, first_alloc, attempts]])
    #       observe a wave of simultaneous completions in one fused
    #       observe dispatch per pool;
    #   abandon(task)
    #       drop in-flight state for an aborted task;
    #   note_clock(t_h) / note_interruption(task, elapsed_h)
    #       engine telemetry hooks, live steps only (quality rows /
    #       crash-aware sizing counters — see SizeyMethod);
    #   note_pressure(p)
    #       live sizing pressure sample (ClusterEngine.pressure()) fed
    #       before each scheduling round; risk-priced methods consume it.
    #       The serial simulate() below never calls it, so serial runs
    #       price at pressure 0.0 (generous sizing) by construction;
    #   strategy_for(task) -> str / checkpoint_frac_for(task) -> float
    #       per-task failure-strategy auto-selection (engine-side
    #       failure_strategy="auto"): asked once per live sized wave and
    #       journaled, never re-asked at replay;
    #   export_state() / restore_state(state) and
    #   export_pending(task) / restore_pending(task, blob)
    #       durability protocol: journal-ride the method state seeds
    #       cannot re-derive (see repro.workflow.journal).


@dataclasses.dataclass
class ClusterMetrics:
    """Cluster-level execution metrics (filled by the event-driven engine).

    ``mean_queue_delay_h`` / ``max_queue_delay_h`` aggregate *dispatched*
    tasks only: admission-rejected (never-started) tasks are counted in
    ``n_aborted`` instead of polluting the delay statistics with synthetic
    zero-delay samples.
    """
    n_nodes: int
    node_cap_gb: float                 # largest node capacity
    makespan_h: float
    mean_queue_delay_h: float
    max_queue_delay_h: float
    node_util: dict[str, float]        # time-averaged reserved fraction
    peak_reserved_gb: float            # peak concurrent reservation, cluster-wide
    n_waves: int                       # scheduling rounds that sized >= 1 task
    n_size_calls: int                  # allocate_batch / allocate-loop calls
    # heterogeneous / failure-aware engine fields
    policy: str = "backfill"
    node_caps_gb: dict[str, float] = dataclasses.field(default_factory=dict)
    class_util: dict[str, float] = \
        dataclasses.field(default_factory=dict)   # per node-class, cap-weighted
    n_aborted: int = 0                 # admission rejections + ladder aborts
    n_preemptions: int = 0             # evictions by the preemptive policy
    n_node_failures: int = 0           # injected node crashes
    node_downtime_h: dict[str, float] = \
        dataclasses.field(default_factory=dict)
    # temporal / batched-observe engine fields
    n_resizes: int = 0                 # successful reservation resizes
    n_resize_waves: int = 0            # coalesced same-clock resize drains
    n_grow_failures: int = 0           # denied grows (node full at boundary)
    n_complete_waves: int = 0          # event drains with >= 1 completion
    # failure-model expansion fields. Counting convention:
    # ``n_failure_events`` counts injected crash EVENTS (one per node fault
    # and one per rack outage), ``n_node_failures`` counts crashed NODES
    # (a rack outage downing 4 nodes adds 4) — correlated and independent
    # failure runs are therefore comparable on either axis.
    failure_strategy: str = "retry_same"
    n_failure_events: int = 0          # injected crash events (node + rack)
    n_rack_failures: int = 0           # rack-outage events
    n_straggler_attempts: int = 0      # dispatched attempts with slowdown > 1
    straggler_extra_h: float = 0.0     # wall time added by straggler stretch
    # node-hours held down by COMPLETED rack outages of each rack (the
    # correlated-failure attribution axis; independent-fault downtime
    # stays in node_downtime_h only)
    rack_downtime_h: dict[str, float] = \
        dataclasses.field(default_factory=dict)
    # durable-scheduler fields: how many times this run's engine
    # was crash-recovered from its journal, and how many journaled steps
    # were replayed across those recoveries. Both 0 for an uninterrupted
    # run — and the ONLY fields a warm (journal-complete) resume is
    # allowed to change (see tests/chaos.py::results_equal).
    n_recoveries: int = 0
    n_replayed_steps: int = 0
    # trace-scale engine work counters: deterministic measures of
    # how much the event loop did — events drained off the heap, queue
    # entries examined by placement scans, event-heap insertions. Pure
    # functions of (trace, config, seeds), so the regression gate pins
    # them at zero growth independent of wall clock.
    n_events: int = 0
    n_scan_entries: int = 0
    n_heap_pushes: int = 0

    @property
    def mean_util(self) -> float:
        """Capacity-weighted cluster utilization: the fraction of total
        cluster memory that was reserved, time-averaged. On heterogeneous
        mixes an unweighted mean of per-node fractions would count a busy
        16 GB node the same as a busy 64 GB one; this is the honest
        headline number (falls back to the unweighted mean when per-node
        capacities are unknown)."""
        if not self.node_util:
            return 0.0
        if not self.node_caps_gb:
            return sum(self.node_util.values()) / len(self.node_util)
        total_cap = sum(self.node_caps_gb.values())
        return sum(self.node_caps_gb[n] * u
                   for n, u in self.node_util.items()) / total_cap


@dataclasses.dataclass
class SimResult:
    workflow: str
    method: str
    ttf: float
    outcomes: list[TaskOutcome]
    cluster: ClusterMetrics | None = None

    @property
    def wastage_gbh(self) -> float:
        return sum(o.wastage_gbh for o in self.outcomes)

    @property
    def temporal_wastage_gbh(self) -> float:
        """Time-integrated waste: integral of reserved-minus-used GB·h.

        Defined for EVERY allocator (peak-based ones reserve a constant,
        so their integral counts the headroom under the usage curve too),
        which puts peak and temporal methods on one Fig. 8-style axis.
        Equals ``wastage_gbh`` when the trace carries no usage curves.
        """
        return sum(o.tw_gbh for o in self.outcomes)

    @property
    def oom_wastage_gbh(self) -> float:
        """GB·h burned by OOM kills (underprediction cost)."""
        return sum(o.oom_gbh for o in self.outcomes)

    @property
    def interruption_wastage_gbh(self) -> float:
        """GB·h burned by crashes/preemptions (lost reservation only —
        checkpoint-retained work is charged as headroom, not here)."""
        return sum(o.interruption_gbh for o in self.outcomes)

    @property
    def failure_wastage_gbh(self) -> float:
        """Total failure-caused waste (OOM + interruption GB·h): the one
        axis on which failure-handling strategies compete (Ponder-style
        comparison — headroom waste belongs to the sizing method, failure
        waste to the strategy x sizing interaction)."""
        return self.oom_wastage_gbh + self.interruption_wastage_gbh

    @property
    def total_runtime_h(self) -> float:
        return sum(o.runtime_h for o in self.outcomes)

    @property
    def makespan_h(self) -> float:
        """Wall time until the last completion event. Equals
        ``total_runtime_h`` for the serial replay; much smaller for a
        concurrent cluster run."""
        return max((o.finish_h for o in self.outcomes), default=0.0)

    @property
    def n_failures(self) -> int:
        return sum(o.failures for o in self.outcomes)

    def failures_by_type(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for o in self.outcomes:
            out[o.task.task_type] = out.get(o.task.task_type, 0) + o.failures
        return out

    def wastage_over_time(self) -> list[tuple[float, float]]:
        """Cumulative (event_time_h, wastage_gbh) curve (Fig. 8a/8b x-axis).

        Points are ordered by each task's *completion timestamp*, so serial
        and cluster results plot on the same (wall-clock) axis. For the
        serial replay the timestamps are the running sum of per-task wall
        times, i.e. the pre-cluster behaviour is preserved exactly.
        """
        w = 0.0
        curve = []
        for o in sorted(self.outcomes, key=lambda o: o.finish_h):
            w += o.wastage_gbh
            curve.append((o.finish_h, w))
        return curve


def _bursts(tasks: list[TaskInstance]):
    """Group consecutive submissions of the same DAG stage: tasks in one
    stage are submitted together (no completion can be observed in between),
    so they form the natural batch of the batched scheduler API."""
    burst: list[TaskInstance] = []
    for task in tasks:
        if burst and task.stage != burst[0].stage:
            yield burst
            burst = []
        burst.append(task)
    if burst:
        yield burst


def simulate(trace: WorkflowTrace, method: SizingMethod,
             ttf: float = 1.0, *, batch_stages: bool = False) -> SimResult:
    """Replay ``trace`` against ``method`` on one implicit machine.

    ``batch_stages=True`` submits each DAG stage as one burst through the
    method's ``allocate_batch`` (if it has one) — the realistic cluster
    scenario where a scheduler dispatches a whole ready stage at once and
    Sizey amortizes K decisions into one device launch. Completions (and
    thus model updates) still happen per task, after the burst is sized.

    For concurrent multi-node execution with instance-level dependencies
    use :func:`repro.workflow.cluster.simulate_cluster`.
    """
    outcomes: list[TaskOutcome] = []
    clock = 0.0
    batched = batch_stages and hasattr(method, "allocate_batch")
    bursts = _bursts(trace.tasks) if batched else ([t] for t in trace.tasks)
    for burst in bursts:
        if batched:
            allocs = [float(a) for a in method.allocate_batch(burst)]
        else:
            allocs = [float(method.allocate(t)) for t in burst]
        for task, first_alloc in zip(burst, allocs):
            o = _run_one(trace, method, task, first_alloc, ttf, clock)
            clock = o.finish_h
            outcomes.append(o)
    return SimResult(trace.name, method.name, ttf, outcomes)


def _run_one(trace: WorkflowTrace, method: SizingMethod, task: TaskInstance,
             first_alloc: float, ttf: float, clock: float) -> TaskOutcome:
    # heterogeneous traces carry per-instance machine caps; the serial
    # machine then clamps/aborts against the task's own machine class
    cap = (trace.machine_cap_gb if task.machine_cap_gb is None
           else task.machine_cap_gb)
    led = AttemptLedger(task, first_alloc, cap, ttf)
    if hasattr(method, "plan_for"):
        # temporal methods attach a reservation plan to the first attempt;
        # on the serial machine resizes always succeed (one task at a
        # time), so the plan only changes the waste/failure arithmetic.
        # Retries fall back to the flat ladder (apply_retry drops the plan).
        plan = method.plan_for(task)
        if plan is not None:
            led.set_plan(plan.clamped(cap))
    while not led.will_succeed:
        if led.record_failure():
            break
        led.apply_retry(method)
    if led.aborted:
        if hasattr(method, "abandon"):
            method.abandon(task)  # let the method drop in-flight state
    else:
        led.record_success()
        method.complete(task, first_alloc, led.attempts)
    return led.outcome(submit_h=clock, start_h=clock,
                       finish_h=clock + led.runtime_h)
