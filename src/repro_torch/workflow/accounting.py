"""Per-attempt waste/retry arithmetic shared by the serial replay and the
event-driven cluster engine (paper §III-A semantics, one source of truth).

The serial simulator runs a task to completion in one tight loop; the
cluster engine interleaves attempts of many tasks across an event queue.
Both step the same ``AttemptLedger`` state machine, so the two paths
cannot drift apart:

  * a killed attempt burns its whole allocation for ``ttf * runtime``;
  * a successful attempt wastes ``(allocation - actual) * runtime`` GBh;
  * retries follow the method's own policy, clamped to the machine/node
    capacity; a task is aborted once even the capacity fails or the
    ``MAX_ATTEMPTS`` safety valve trips;
  * a *preempted* or *crash-killed* attempt (heterogeneous cluster engine)
    burns only the partial reservation it held — it is an interruption,
    not an OOM failure: no failure count, no retry-ladder step, no abort
    pressure.

Failure-handling strategies (Ponder-style, arXiv 2408.00047) change what
an *interruption* costs — OOM arithmetic is identical under every
strategy, so the sizing comparison stays apples-to-apples:

  * ``retry_same`` (default, the pre-strategy semantics): the killed
    attempt burns its whole partial reservation and re-runs from scratch
    under the same reservation;
  * ``retry_scaled``: same burn arithmetic, but the engine re-sizes the
    attempt through the method before re-dispatch (``refresh_pending``),
    so a tightened prediction shrinks what the next crash can burn;
  * ``checkpoint``: the attempt checkpoints every ``checkpoint_frac`` of
    its runtime; a crash burns the full reservation only for the work
    since the last checkpoint (``interruption_gbh``) and the mere
    *headroom* for the retained prefix, and the re-run executes only the
    remaining ``1 - completed_frac`` of the task. Retention applies to
    attempts that would have succeeded (a doomed attempt was running
    over-limit — its "progress" is an artifact, so it burns in full, and
    an OOM kill always restarts from scratch: the bigger-allocation rerun
    re-executes everything). A *temporal* (multi-segment-plan) attempt
    retains up to the last plan segment boundary it completed: the plan
    survives the interruption and the re-run resumes the reservation
    schedule from that boundary (``start_alloc_gb`` is the plan value
    there, RESIZE events cover only the remaining boundaries) instead of
    re-running — and re-burning — the whole plan from segment 0.

Every ledger splits its waste by *cause*: ``oom_gbh`` (burned by OOM
kills) + ``interruption_gbh`` (burned by crashes/preemptions, the truly
lost reservation) + implicit headroom (``wastage_gbh`` minus both), so
interruption vs OOM waste is attributable per failure-handling strategy.

Straggler injection stretches an attempt in *time*: ``slowdown >= 1``
multiplies the attempt's wall duration and therefore every reservation
time-integral (the usage curve stretches with it — the same work takes
longer). ``slowdown`` is per-attempt state set by the engine at dispatch;
1.0 (the default, and always the serial replay's value) is arithmetically
inert: multiplying by 1.0 is exact in IEEE-754, so failure-free traces
stay bitwise-identical.

Temporal attempts (KS+-style time-segmented allocators) extend the state
machine without touching the legacy arithmetic:

  * a :class:`~repro_torch.core.temporal.segments.ReservationPlan` with >= 2
    segments makes the attempt *temporal*: the reservation follows the
    plan (the engines resize at segment boundaries) and success requires
    the plan to cover the task's ground-truth ``usage_curve`` at every
    time, not just its peak;
  * a temporal OOM kill happens at the curve's first crossing of the plan
    (the violation time IS the time-to-failure, so ``ttf`` does not scale
    it) and burns the plan's partial reservation integral;
  * a plan with ONE segment is a constant reservation — it is executed on
    the legacy peak path, arithmetic bitwise-identical to a plain
    allocation (the resize-disabled / k=1 configuration);
  * retries after any failure fall back to a FLAT reservation from the
    method's ladder (after an OOM you size conservatively), as do plans
    that failed to grow ``MAX_GROW_FAILURES`` times on a busy node.

Every ledger additionally tracks **time-integrated waste** ``tw_gbh``:
integral of (reserved(t) - used(t)) over the attempt, using the task's
usage curve (flat at the peak when the trace carries none — in which case
``tw_gbh == wastage_gbh`` exactly). Peak and temporal allocators therefore
plot on one Fig. 8-style GB·h axis.

``cap_gb`` is per-ledger: the serial replay passes the machine capacity
(or the task's own ``machine_cap_gb`` when the trace is heterogeneous),
the cluster engine the capacity of the *largest node the task could ever
be placed on* — so clamp/abort semantics follow the hardware the task can
actually reach, not a global constant.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.temporal.segments import ReservationPlan
from repro_torch.workflow.trace import TaskInstance

MAX_ATTEMPTS = 16  # safety valve; the doubling ladder reaches any cap first

# Ponder-style failure-handling strategies (see module docstring): how an
# interrupted (crashed/preempted) attempt is charged and re-run
FAILURE_STRATEGIES = ("retry_same", "retry_scaled", "checkpoint")

# checkpoint cadence of the "checkpoint" strategy: one checkpoint every
# this fraction of the task's runtime (methods may override via a
# ``checkpoint_frac`` attribute)
DEFAULT_CHECKPOINT_FRAC = 0.25

# after this many failed reservation *grows* (node too full at a segment
# boundary) the plan flattens to a constant peak reservation — placement
# then serializes the task like any peak attempt, guaranteeing progress
MAX_GROW_FAILURES = 3


def doubling_retry(last_alloc_gb: float, cap_gb: float) -> float:
    """The standard resource-manager failure ladder: double, clamp to cap."""
    return min(last_alloc_gb * 2.0, cap_gb)


@dataclasses.dataclass
class TaskOutcome:
    task: TaskInstance
    first_alloc_gb: float
    final_alloc_gb: float
    attempts: int
    failures: int
    wastage_gbh: float
    runtime_h: float            # wall time incl. failed attempts
    aborted: bool = False
    interruptions: int = 0      # preemptions / node-crash kills (not OOMs)
    # time-integrated waste: integral of reserved-minus-used GB·h over the
    # task's attempts (== wastage_gbh when the trace carries no usage
    # curves). The one axis peak and temporal allocators share.
    tw_gbh: float = 0.0
    grow_failures: int = 0      # denied reservation grows (temporal plans)
    # waste attribution by cause (oom + interruption + headroom == total):
    # OOM kills burn oom_gbh, crash/preemption kills burn interruption_gbh
    # (under "checkpoint" only the since-last-checkpoint loss counts here),
    # the rest of wastage_gbh is over-provisioning headroom
    oom_gbh: float = 0.0
    interruption_gbh: float = 0.0
    # event timestamps (filled by the simulators; serial replay uses a
    # running clock, the cluster engine real event times)
    submit_h: float = 0.0       # became ready / was submitted
    start_h: float = 0.0        # first attempt dispatched
    finish_h: float = 0.0       # completed or aborted

    @property
    def queue_delay_h(self) -> float:
        return self.start_h - self.submit_h


@dataclasses.dataclass
class AttemptLedger:
    """Mutable per-task attempt state, stepped identically by both engines."""
    task: TaskInstance
    first_alloc_gb: float
    cap_gb: float               # machine (serial) or node (cluster) capacity
    ttf: float
    alloc_gb: float = dataclasses.field(init=False)
    attempts: int = 1
    failures: int = 0
    wastage_gbh: float = 0.0
    runtime_h: float = 0.0
    aborted: bool = False
    interruptions: int = 0
    tw_gbh: float = 0.0
    # temporal state: the reservation plan of the CURRENT attempt (None =
    # flat legacy reservation at alloc_gb)
    plan: ReservationPlan | None = None
    grow_failures: int = 0
    # failure-handling strategy of this task's interruptions (engine passes
    # the method's choice; the serial replay never interrupts, so the
    # default is inert there)
    failure_strategy: str = "retry_same"
    checkpoint_frac: float = DEFAULT_CHECKPOINT_FRAC
    # work retained from checkpoints: the re-run executes [completed_frac,1]
    completed_frac: float = 0.0
    # straggler stretch of the CURRENT attempt's wall time (>= 1.0; set by
    # the engine at dispatch, reset to 1.0 for every new dispatch)
    slowdown: float = 1.0
    # waste attribution by cause (see TaskOutcome)
    oom_gbh: float = 0.0
    interruption_gbh: float = 0.0
    # retry_scaled: set after an interruption; the engine re-sizes the task
    # through the method before the next dispatch, then clears it
    refresh_pending: bool = False

    def __post_init__(self):
        self.alloc_gb = self.first_alloc_gb
        self._violation: float | None | bool = False  # False = not computed
        if self.failure_strategy not in FAILURE_STRATEGIES:
            raise ValueError(
                f"unknown failure strategy {self.failure_strategy!r} "
                f"(have {FAILURE_STRATEGIES})")

    # ------------------------------------------------------------ temporal
    def set_plan(self, plan: ReservationPlan | None) -> None:
        """Attach a reservation plan to the current attempt. Single-segment
        plans are a constant reservation == the legacy path; they are
        dropped here so every downstream branch sees ``temporal_active ==
        False`` and the arithmetic stays bitwise-identical to a plain
        allocation (the k=1 acceptance invariant)."""
        if plan is not None:
            plan = plan.simplify()
            if plan.k <= 1:
                plan = None
        self.plan = plan
        self._violation = False

    @property
    def temporal_active(self) -> bool:
        return self.plan is not None

    @property
    def start_alloc_gb(self) -> float:
        """What dispatch actually reserves: the plan's value at the resume
        point for a temporal attempt (its FIRST segment when nothing is
        retained — checkpoint retention resumes mid-plan), the flat
        allocation otherwise."""
        if self.plan is not None:
            if self.completed_frac > 0.0:
                return self.plan.value_at(self.completed_frac)
            return self.plan.start_gb
        return self.alloc_gb

    @property
    def violation_frac(self) -> float | None:
        """First runtime fraction where usage exceeds the plan (None =
        the plan covers the whole curve). An empty ``usage_curve`` means
        "flat at the peak" (legacy trace semantics), so a plan must cover
        ``actual_peak_gb`` for the whole runtime there — a multi-segment
        plan can never dodge an OOM just because the trace carries no
        time-resolved ground truth. Cached per attempt."""
        if self._violation is False:
            if self.plan is None:
                self._violation = None
            else:
                curve = (self.task.usage_curve
                         or ((1.0, self.task.actual_peak_gb),))
                self._violation = self.plan.first_violation(curve)
        return self._violation

    def _reserved_gbh(self, upto_frac: float, frm: float = 0.0) -> float:
        """GB·h reserved over the ``[frm, upto_frac]`` window of the
        (straggler-stretched) runtime under the current attempt's
        reservation (plan or flat). Fractions are of *nominal* runtime; a
        straggler holds the same reservation ``slowdown`` times longer in
        wall time. ``frm > 0`` is the mid-plan resume window (a retained
        attempt never re-reserves its completed prefix)."""
        if self.plan is not None:
            gbh = self.plan.gbh(self.task.runtime_h, upto_frac)
            if frm > 0.0:
                gbh -= self.plan.gbh(self.task.runtime_h, frm)
            return gbh * self.slowdown
        if frm > 0.0:
            return self.alloc_gb * (upto_frac - frm) * self.task.runtime_h \
                * self.slowdown
        return self.alloc_gb * upto_frac * self.task.runtime_h \
            * self.slowdown

    # ----------------------------------------------------- engine controls
    def set_slowdown(self, slowdown: float) -> None:
        """Straggler stretch for the attempt about to dispatch (>= 1)."""
        if slowdown < 1.0:
            raise ValueError(f"slowdown must be >= 1, got {slowdown}")
        self.slowdown = slowdown

    def refresh_alloc(self, alloc_gb: float) -> float:
        """retry_scaled re-size after an interruption: the method's fresh
        allocation replaces the current one (clamped to capacity) WITHOUT
        an attempt/ladder step — the crash was not the sizing's fault. Any
        plan is dropped (the re-run is flat). Clears ``refresh_pending``."""
        self.alloc_gb = min(float(alloc_gb), self.cap_gb)
        self.plan = None
        self._violation = False
        self.refresh_pending = False
        return self.alloc_gb

    # ------------------------------------------------------------- queries
    @property
    def will_succeed(self) -> bool:
        """Strict limits (assumption A3): the attempt survives iff the
        reservation covers the ground-truth usage — the peak for a flat
        attempt, the whole curve for a temporal one."""
        if self.plan is not None:
            return self.violation_frac is None
        return self.alloc_gb >= self.task.actual_peak_gb

    @property
    def attempt_duration_h(self) -> float:
        """Wall time of the *next* attempt: full (remaining) runtime on
        success. A flat attempt that will OOM runs for the ttf-scaled
        prefix (the paper's simulation parameter); a temporal attempt dies
        exactly at the curve's first crossing of the plan (the violation
        time IS the time-to-failure, so ttf does not apply). A straggler
        attempt stretches by ``slowdown``; checkpoint retention shrinks a
        succeeding re-run to the un-retained suffix."""
        if self.will_succeed:
            return self.task.runtime_h * self.slowdown \
                * (1.0 - self.completed_frac)
        if self.plan is not None:
            # a resumed plan runs [completed_frac, violation]; cf == 0.0
            # keeps the subtraction bitwise-inert
            return max(self.violation_frac - self.completed_frac, 0.0) \
                * self.task.runtime_h * self.slowdown
        return self.ttf * self.task.runtime_h * self.slowdown

    # ------------------------------------------------------------- records
    def record_failure(self) -> bool:
        """Account one killed attempt; returns True when the task must be
        aborted (capacity exhausted or the safety valve tripped).

        Boundary: ``attempts`` counts *dispatched* attempts and starts at 1;
        ``apply_retry`` increments it only when a further attempt is
        actually granted. The valve therefore trips on the failure of the
        MAX_ATTEMPTS-th attempt — exactly MAX_ATTEMPTS attempts run, never
        MAX_ATTEMPTS + 1 (pinned in tests/test_cluster_hetero.py).
        """
        if self.plan is not None:
            # temporal OOM: everything reserved up to the violation burned
            # (from the resume point for a retained plan; cf == 0.0 keeps
            # the default path bitwise)
            frac = self.violation_frac
            burn = self._reserved_gbh(frac, self.completed_frac)
            self.wastage_gbh += burn
            self.tw_gbh += burn
            self.runtime_h += max(frac - self.completed_frac, 0.0) \
                * self.task.runtime_h * self.slowdown
        else:
            burn = self.alloc_gb * self.ttf * self.task.runtime_h \
                * self.slowdown
            self.wastage_gbh += burn
            self.tw_gbh += burn
            self.runtime_h += self.ttf * self.task.runtime_h * self.slowdown
        self.oom_gbh += burn
        # an OOM kill loses the process: checkpoints of the too-small
        # attempt are not resumable by the larger re-run (strict-limit
        # semantics — the working set never fit), so retention resets
        self.completed_frac = 0.0
        self.failures += 1
        if self.alloc_gb >= self.cap_gb or self.attempts >= MAX_ATTEMPTS:
            self.aborted = True
        return self.aborted

    def record_interruption(self, elapsed_h: float, *,
                            charge_interruption: bool = True) -> None:
        """A preemption or node crash killed the attempt ``elapsed_h`` into
        its run. This is NOT an OOM failure: no failure count, no
        retry-ladder step, no abort pressure.

        ``charge_interruption=False`` keeps the burn out of
        ``interruption_gbh``: temporal grow *denials* use the same
        burn-and-requeue arithmetic but are placement congestion, not a
        failure event — they must not pollute the Ponder-style
        failure-waste axis of a crash-free run.

        Under ``retry_same`` / ``retry_scaled`` the whole partial
        reservation is burned (nothing useful survives the kill) and the
        attempt re-runs in full. Under ``checkpoint`` an attempt that
        would have succeeded retains completed work: a flat attempt the
        prefix up to its last ``checkpoint_frac`` checkpoint, a temporal
        attempt the prefix up to the last *plan segment boundary* it
        passed (segment boundaries are the plan's natural checkpoints —
        the reservation changes there anyway). Only the since-checkpoint
        reservation is truly lost (``interruption_gbh``); the retained
        prefix is charged its over-provisioning headroom, and
        ``completed_frac`` advances so the re-run executes only the
        suffix. A retained temporal attempt KEEPS its plan and resumes
        the reservation schedule mid-plan (``start_alloc_gb`` /
        ``_reserved_gbh`` read from ``completed_frac``). Doomed attempts
        never retain (see module docstring)."""
        retained = self.completed_frac
        if (self.failure_strategy == "checkpoint"
                and self.checkpoint_frac > 0 and self.will_succeed):
            wall_rt = self.task.runtime_h * self.slowdown
            pos = self.completed_frac + elapsed_h / max(wall_rt, 1e-12)
            if self.plan is None:
                retained = min(math.floor(pos / self.checkpoint_frac)
                               * self.checkpoint_frac, 1.0)
                retained = max(retained, self.completed_frac)
            else:
                # temporal: the last plan boundary reached (1.0 is the plan
                # end, not a resumable boundary)
                for end, _gb in self.plan.segments[:-1]:
                    if self.completed_frac < end <= pos + 1e-12:
                        retained = end
        if retained > self.completed_frac:
            wall_rt = self.task.runtime_h * self.slowdown
            retained_dt = (retained - self.completed_frac) * wall_rt
            # the retained prefix DID useful work: charge only headroom
            # (peak-based for wastage_gbh, curve-integrated for tw_gbh —
            # the same split record_success uses)
            used_gbh = (self.task.usage_gbh(retained)
                        - self.task.usage_gbh(self.completed_frac)) \
                * self.slowdown
            if self.plan is not None:
                # reservation followed the plan: the retained window is
                # charged plan-minus-used, the lost [retained, pos] window
                # burned in full (a temporal attempt's wastage IS its
                # integral — same convention as record_success)
                pos = min(self.completed_frac
                          + elapsed_h / max(wall_rt, 1e-12), 1.0)
                res_retained = self._reserved_gbh(retained,
                                                  self.completed_frac)
                lost = self._reserved_gbh(pos, retained)
                self.wastage_gbh += lost + (res_retained - used_gbh)
                self.tw_gbh += lost + (res_retained - used_gbh)
            else:
                lost_dt = max(elapsed_h - retained_dt, 0.0)
                lost = self.alloc_gb * lost_dt
                self.wastage_gbh += lost + (self.alloc_gb
                                            - self.task.actual_peak_gb) \
                    * retained_dt
                self.tw_gbh += lost + (self.alloc_gb * retained_dt
                                       - used_gbh)
            if charge_interruption:
                self.interruption_gbh += lost
            self.completed_frac = retained
        else:
            if self.plan is not None:
                frac = min(elapsed_h / max(self.task.runtime_h
                                           * self.slowdown, 1e-12), 1.0)
                burn = self._reserved_gbh(frac)
            else:
                burn = self.alloc_gb * elapsed_h
            self.wastage_gbh += burn
            self.tw_gbh += burn
            if charge_interruption:
                self.interruption_gbh += burn
        self.runtime_h += elapsed_h
        self.interruptions += 1

    def record_grow_failure(self, elapsed_h: float) -> None:
        """A segment-boundary grow found its node too full: interruption
        accounting (the partial plan integral is burned, no OOM), plus a
        grow-failure count — but NOT charged to ``interruption_gbh``: a
        denied grow is placement congestion, not a failure event, so the
        failure-waste axis of a crash-free run stays zero. After
        ``MAX_GROW_FAILURES`` denied grows the plan flattens to a constant
        ``alloc_gb`` (== the plan peak) reservation — placement then
        treats the task like any peak attempt and serializes it, so two
        growers can never requeue-livelock each other on a saturated
        node."""
        self.record_interruption(elapsed_h, charge_interruption=False)
        self.grow_failures += 1
        if self.grow_failures >= MAX_GROW_FAILURES:
            self.plan = None
            self._violation = False

    def apply_retry(self, method) -> float:
        """Ask the method for the next allocation (clamped to capacity).
        Retries are always FLAT: after an OOM the ladder sizes
        conservatively, so any plan of the failed attempt is dropped."""
        self.alloc_gb = min(
            float(method.retry(self.task, self.failures, self.alloc_gb)),
            self.cap_gb)
        self.attempts += 1
        self.plan = None
        self._violation = False
        return self.alloc_gb

    def apply_retry_alloc(self, alloc_gb: float) -> float:
        """Journal-replay variant of :meth:`apply_retry`: apply a
        previously *recorded* retry allocation without consulting the
        method (whose mutable pool state has moved on since the decision
        was journaled). Same ladder semantics: clamp, count the attempt,
        drop any plan."""
        self.alloc_gb = min(float(alloc_gb), self.cap_gb)
        self.attempts += 1
        self.plan = None
        self._violation = False
        return self.alloc_gb

    # -------------------------------------------------------- durability
    _STATE_FIELDS = ("first_alloc_gb", "cap_gb", "ttf", "alloc_gb",
                     "attempts", "failures", "wastage_gbh", "runtime_h",
                     "aborted", "interruptions", "tw_gbh", "grow_failures",
                     "failure_strategy", "checkpoint_frac", "completed_frac",
                     "slowdown", "oom_gbh", "interruption_gbh",
                     "refresh_pending")

    def to_state(self) -> dict:
        """JSON-safe snapshot of the ledger (task carried by key — the
        trace is the caller's to re-resolve). Floats round-trip exactly
        through ``json`` (shortest-repr), so a restored ledger is bitwise
        the live one."""
        state = {f: getattr(self, f) for f in self._STATE_FIELDS}
        state["task"] = list(self.task.key)
        state["plan"] = ([list(s) for s in self.plan.segments]
                        if self.plan is not None else None)
        return state

    @classmethod
    def from_state(cls, task: TaskInstance, state: dict) -> "AttemptLedger":
        led = cls(task, state["first_alloc_gb"], state["cap_gb"],
                  state["ttf"], failure_strategy=state["failure_strategy"],
                  checkpoint_frac=state["checkpoint_frac"])
        for f in cls._STATE_FIELDS:
            setattr(led, f, state[f])
        if state["plan"] is not None:
            led.plan = ReservationPlan(
                tuple((float(e), float(g)) for e, g in state["plan"]))
        # _violation stays un-computed: the cache is re-derived on demand
        # from (plan, curve), both of which round-trip exactly
        return led

    def record_success(self) -> None:
        # wall time of the successful run: straggler-stretched, shrunk to
        # the un-retained suffix under checkpoint retention (both factors
        # are exactly 1.0 on the default path — bitwise-inert)
        rt = self.task.runtime_h * self.slowdown * (1.0 - self.completed_frac)
        if self.completed_frac > 0.0:
            used = (self.task.usage_gbh()
                    - self.task.usage_gbh(self.completed_frac)) \
                * self.slowdown
        else:
            used = self.task.usage_gbh() * self.slowdown
        if self.plan is not None:
            tw = self._reserved_gbh(1.0, self.completed_frac) - used
            # a temporal attempt's "peak-based" wastage IS its integral —
            # there is no meaningful constant-reservation reading of a plan
            self.wastage_gbh += tw
            self.tw_gbh += tw
        else:
            self.wastage_gbh += (self.alloc_gb - self.task.actual_peak_gb) \
                * rt
            self.tw_gbh += self.alloc_gb * rt - used
        self.runtime_h += rt

    def outcome(self, *, submit_h: float = 0.0, start_h: float = 0.0,
                finish_h: float = 0.0) -> TaskOutcome:
        return TaskOutcome(self.task, self.first_alloc_gb, self.alloc_gb,
                           self.attempts, self.failures, self.wastage_gbh,
                           self.runtime_h, self.aborted,
                           interruptions=self.interruptions,
                           tw_gbh=self.tw_gbh,
                           grow_failures=self.grow_failures,
                           oom_gbh=self.oom_gbh,
                           interruption_gbh=self.interruption_gbh,
                           submit_h=submit_h, start_h=start_h,
                           finish_h=finish_h)
