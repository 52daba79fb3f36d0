"""Adapter exposing SizeyPredictor through the SizingMethod protocol (the
reference's ``repro.baselines.sizey_method``).

``temporal_k`` switches the method onto the temporal subsystem: the
:class:`~repro_torch.core.temporal.predictor.TemporalSizeyPredictor`
predicts a k-segment reservation plan per task (one dispatch per pool for a
whole wave, segments stacked), ``plan_for`` hands the plan to the engines
(which resize at segment boundaries), and completions feed the
per-segment peaks back. ``temporal_k=1`` is the peak path, bitwise.

``failure_strategy`` picks the crash handling the engines apply to this
method's attempts (``retry_same`` / ``retry_scaled`` / ``checkpoint``;
see :mod:`repro_torch.workflow.accounting`). Under ``checkpoint`` the
method sizes *crash-aware*: the safety offset shrinks toward the raw
aggregate prediction by ``1 - exp(-rate x mean_runtime)``, the chance an
attempt is interrupted at least once. With no observed crash the fold is
a no-op.

Not ported yet, each raising ``NotImplementedError`` that names its slice
(ROADMAP.md, Queue 1): ``risk`` and ``failure_strategy="auto"`` (the risk
slice), ``quality=True`` (the telemetry part of the same slice), and the
journal's durability hooks (``export_state`` / ``export_pending`` and
their inverses, the cluster-engine slice).
"""
from __future__ import annotations

import math

from repro_torch.core.config import SizeyConfig
from repro_torch.core.predictor import SizeyPredictor, SizingDecision
from repro_torch.core.provenance import ProvenanceDB
from repro_torch.core.temporal.predictor import (TemporalDecision,
                                                 TemporalSizeyPredictor)
from repro_torch.workflow.accounting import (DEFAULT_CHECKPOINT_FRAC,
                                             FAILURE_STRATEGIES)
from repro_torch.workflow.trace import TaskInstance


class SizeyMethod:
    """The Sizey predictor behind the ``SizingMethod`` protocol, on
    ``device`` (CUDA by default; ``device="cpu"`` for the plain versions).

    Every allocation is a deterministic function of the observation
    history plus the crash counters, so a replay reproduces it."""

    def __init__(self, cfg: SizeyConfig | None = None, *, ttf: float = 1.0,
                 machine_cap_gb: float = 128.0, name: str | None = None,
                 fused: bool = True, temporal_k: int | None = None,
                 persist_path: str | None = None,
                 failure_strategy: str = "retry_same",
                 checkpoint_frac: float = DEFAULT_CHECKPOINT_FRAC,
                 quality: bool = False, risk=None, device=None):
        if risk:
            raise NotImplementedError(
                "risk: the risk slice (ROADMAP.md Queue 1 slice 3) is not "
                "ported yet")
        if failure_strategy == "auto":
            raise NotImplementedError(
                "failure_strategy='auto' selects strategies from the risk "
                "signals: it comes with the risk slice (ROADMAP.md Queue 1 "
                "slice 3)")
        if quality:
            raise NotImplementedError(
                "quality=True: prediction-quality telemetry comes with the "
                "risk and telemetry slice (ROADMAP.md Queue 1 slice 3)")
        if failure_strategy not in FAILURE_STRATEGIES:
            raise ValueError(
                f"unknown failure strategy {failure_strategy!r} "
                f"(have {FAILURE_STRATEGIES})")
        self.failure_strategy = failure_strategy
        self.checkpoint_frac = checkpoint_frac
        # crash-aware sizing state: interruptions observed vs attempt-hours
        # of exposure (completed runtimes + hours lost to crashes)
        self._crash_events = 0
        self._exposure_h = 0.0
        self._runtime_sum_h = 0.0
        self._n_completed = 0
        self.temporal = temporal_k is not None
        self.name = name if name is not None else (
            "sizey_temporal" if self.temporal and temporal_k > 1 else "sizey")
        if self.temporal:
            self.predictor = TemporalSizeyPredictor(
                cfg, k_segments=temporal_k, ttf=ttf,
                default_machine_cap_gb=machine_cap_gb, fused=fused,
                persist_path=persist_path, device=device)
        else:
            cfg = cfg or SizeyConfig()
            db = ProvenanceDB(n_features=1, n_models=len(cfg.model_classes),
                              persist_path=persist_path, device=device)
            self.predictor = SizeyPredictor(
                cfg, db, ttf=ttf, default_machine_cap_gb=machine_cap_gb,
                fused=fused)
            if persist_path and db.records:
                self.predictor.warm_start()   # checkpoint restore
        # decisions of in-flight tasks, keyed by task identity
        self._pending: dict[int, SizingDecision | TemporalDecision] = {}

    def _crash_aware_alloc(self, decision: SizingDecision) -> float:
        """Fold the observed crash rate into the offset choice (the
        ``checkpoint`` strategy), floored at the aggregate prediction;
        presets and crash-free histories pass through untouched."""
        alloc = decision.allocation_gb
        if (self.failure_strategy != "checkpoint"
                or not self._crash_events or decision.offset_gb <= 0.0):
            return alloc
        rate_per_h = self._crash_events / max(self._exposure_h, 1e-9)
        mean_rt = self._runtime_sum_h / max(self._n_completed, 1)
        shrink = 1.0 - math.exp(-rate_per_h * mean_rt)
        return max(decision.agg_pred_gb, alloc - decision.offset_gb * shrink)

    def note_interruption(self, task: TaskInstance,
                          elapsed_h: float) -> None:
        """Engine hook: a crash killed one of this method's attempts
        ``elapsed_h`` into its run."""
        self._crash_events += 1
        self._exposure_h += elapsed_h

    def allocate(self, task: TaskInstance) -> float:
        """Size one task's first attempt: predict -> crash-aware offset
        (a temporal method: the peak of the task's plan)."""
        if self.temporal:
            return self.allocate_batch([task])[0]
        decision = self.predictor.predict(
            task.task_type, task.machine, task.features, task.user_preset_gb,
            machine_cap_gb=task.machine_cap_gb)
        self._pending[id(task)] = decision
        return self._crash_aware_alloc(decision)

    def allocate_batch(self, tasks: list[TaskInstance]) -> list[float]:
        """Decide a burst of submissions with one dispatch per pool."""
        decisions = self.predictor.predict_batch(tasks)
        for task, decision in zip(tasks, decisions):
            self._pending[id(task)] = decision
        if self.temporal:
            # a plan is a whole-runtime schedule: the crash-aware offset
            # fold applies to flat (peak) decisions only
            return [d.allocation_gb for d in decisions]
        return [self._crash_aware_alloc(d) for d in decisions]

    def plan_for(self, task: TaskInstance):
        """Reservation plan for the allocation just returned (None for the
        peak path: the engines then run the flat path)."""
        if not self.temporal:
            return None
        return self._pending[id(task)].plan

    def retry(self, task: TaskInstance, attempt: int,
              last_alloc_gb: float) -> float:
        """Re-size after an OOM kill via the paper's retry ladder."""
        return self.predictor.retry_allocation(self._pending[id(task)],
                                               attempt, last_alloc_gb)

    def _note_completion(self, task: TaskInstance) -> None:
        self._runtime_sum_h += task.runtime_h
        self._n_completed += 1
        self._exposure_h += task.runtime_h

    def complete(self, task: TaskInstance, first_alloc_gb: float,
                 attempts: int) -> None:
        """Observe a completion: fold the measured peak and runtime into
        the pool and retrain."""
        decision = self._pending.pop(id(task))
        self._note_completion(task)
        if self.temporal:
            self.predictor.observe(decision, task, attempts)
        else:
            self.predictor.observe(decision, task.actual_peak_gb,
                                   task.runtime_h, attempts, task.workflow)

    def complete_batch(self, items) -> None:
        """Observe a wave of simultaneous completions, one observe dispatch
        per pool (``items``: (task, first_alloc_gb, attempts) tuples)."""
        for task, _first, _attempts in items:
            self._note_completion(task)
        if self.temporal:
            self.predictor.observe_batch(
                [(self._pending.pop(id(task)), task, attempts)
                 for task, _first, attempts in items])
        else:
            self.predictor.observe_batch(
                [(self._pending.pop(id(task)), task.actual_peak_gb,
                  task.runtime_h, attempts, task.workflow)
                 for task, _first, attempts in items])

    def abandon(self, task: TaskInstance) -> None:
        """Task aborted: drop its pending decision."""
        self._pending.pop(id(task), None)

    # The cluster engine's journal persists the crash counters and the
    # in-flight decisions (a "peak" or "temporal" blob) through these hooks;
    # they come with the engine and its journal.
    def _journal_not_ported(self, *_args):
        raise NotImplementedError(
            "the durability hooks come with the cluster engine and its "
            "journal (ROADMAP.md Queue 1 slice 3, item 13)")

    export_state = restore_state = _journal_not_ported
    export_pending = restore_pending = _journal_not_ported
