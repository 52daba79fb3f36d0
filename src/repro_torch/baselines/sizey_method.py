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

The cluster engine's journal persists the crash counters, the last
pressure sample and the in-flight decisions through the durability hooks
(``export_state`` / ``export_pending`` and their inverses), in the
reference's row layout.

Not ported yet, each raising ``NotImplementedError`` that names the risk
slice (ROADMAP.md, Queue 1 item 4): ``risk``, ``failure_strategy="auto"``
and ``quality=True``. The engine's hooks of that slice (``note_clock``,
``strategy_for``, ``checkpoint_frac_for``) are absent, so the engine skips
them; ``note_pressure`` only records the sample, which nothing prices yet.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.config import SizeyConfig
from repro_torch.core.predictor import SizeyPredictor, SizingDecision
from repro_torch.core.provenance import ProvenanceDB
from repro_torch.core.temporal.predictor import (TemporalDecision,
                                                 TemporalSizeyPredictor)
from repro_torch.core.temporal.segments import ReservationPlan
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
                "risk: the risk slice (ROADMAP.md Queue 1 item 4) is not "
                "ported yet")
        if failure_strategy == "auto":
            raise NotImplementedError(
                "failure_strategy='auto' selects strategies from the risk "
                "signals: it comes with the risk slice (ROADMAP.md Queue 1 "
                "item 4)")
        if quality:
            raise NotImplementedError(
                "quality=True: prediction-quality telemetry comes with the "
                "risk and telemetry slice (ROADMAP.md Queue 1 item 4)")
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
        # the engine's last sizing-pressure sample (journaled in the
        # method state; priced by the risk slice)
        self._pressure = 0.0

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

    def note_pressure(self, pressure: float) -> None:
        """Engine hook (live steps only): the sizing pressure in [0, 1] at
        the scheduling round, a pure function of engine state. Recorded
        and journaled; nothing prices it until the risk slice."""
        self._pressure = float(pressure)

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

    # ----------------------------------------------------- durability hooks
    # The cluster engine's journal persists what seeds cannot re-derive:
    # the crash-aware counters (export_state / restore_state, once per
    # step) and the in-flight decisions of dispatched-but-unfinished
    # attempts (export_pending / restore_pending, with each sizing wave and
    # each snapshot). Every decision array is float32, which survives the
    # float64 JSON detour exactly.

    def export_state(self) -> dict:
        """Crash-aware sizing counters and the last pressure sample
        (JSON-safe), journaled once per engine step."""
        return {"crash_events": self._crash_events,
                "exposure_h": self._exposure_h,
                "runtime_sum_h": self._runtime_sum_h,
                "n_completed": self._n_completed,
                "pressure": self._pressure}

    def restore_state(self, state: dict) -> None:
        """Inverse of :meth:`export_state` (the pressure sample defaults to
        0.0 for journals written without one)."""
        self._crash_events = int(state["crash_events"])
        self._exposure_h = float(state["exposure_h"])
        self._runtime_sum_h = float(state["runtime_sum_h"])
        self._n_completed = int(state["n_completed"])
        self._pressure = float(state.get("pressure", 0.0))

    def export_pending(self, task: TaskInstance) -> dict | None:
        """In-flight decision for ``task`` as a JSON-safe blob (None when
        the task has none)."""
        decision = self._pending.get(id(task))
        if decision is None:
            return None
        if self.temporal:
            return {"kind": "temporal",
                    "task_type": decision.task_type,
                    "machine": decision.machine,
                    "boundaries": [float(b) for b in decision.boundaries],
                    "seg_decisions": [_decision_to_json(d)
                                      for d in decision.seg_decisions],
                    "plan": [[float(e), float(g)]
                             for e, g in decision.plan.segments]}
        return _decision_to_json(decision)

    def restore_pending(self, task: TaskInstance, blob: dict) -> None:
        """Rebuild the in-flight decision of ``task`` from a journal blob,
        so the attempt's later retries and completion see the decision it
        was sized with."""
        if blob.get("kind") == "temporal":
            decision = TemporalDecision(
                task_type=blob["task_type"], machine=blob["machine"],
                boundaries=tuple(float(b) for b in blob["boundaries"]),
                seg_decisions=[_decision_from_json(d)
                               for d in blob["seg_decisions"]],
                plan=ReservationPlan(tuple(
                    (float(e), float(g)) for e, g in blob["plan"])))
        else:
            decision = _decision_from_json(blob)
        self._pending[id(task)] = decision


def _arr_to_json(arr) -> dict | None:
    if arr is None:
        return None
    arr = np.asarray(arr)
    return {"dtype": str(arr.dtype), "a": [float(v) for v in arr.ravel()]}


def _arr_from_json(d: dict | None):
    if d is None:
        return None
    return np.asarray(d["a"], dtype=np.dtype(d["dtype"]))


def _decision_to_json(d: SizingDecision) -> dict:
    return {"kind": "peak", "task_type": d.task_type, "machine": d.machine,
            "features": [float(f) for f in d.features], "source": d.source,
            "allocation_gb": float(d.allocation_gb),
            "user_preset_gb": float(d.user_preset_gb),
            "machine_cap_gb": float(d.machine_cap_gb),
            "model_preds": _arr_to_json(d.model_preds),
            "raq": _arr_to_json(d.raq),
            "weights": _arr_to_json(d.weights),
            "agg_pred_gb": float(d.agg_pred_gb),
            "offset_gb": float(d.offset_gb),
            "offset_idx": int(d.offset_idx)}


def _decision_from_json(blob: dict) -> SizingDecision:
    return SizingDecision(
        task_type=blob["task_type"], machine=blob["machine"],
        features=tuple(float(f) for f in blob["features"]),
        source=blob["source"], allocation_gb=blob["allocation_gb"],
        user_preset_gb=blob["user_preset_gb"],
        machine_cap_gb=blob["machine_cap_gb"],
        model_preds=_arr_from_json(blob["model_preds"]),
        raq=_arr_from_json(blob["raq"]),
        weights=_arr_from_json(blob["weights"]),
        agg_pred_gb=blob["agg_pred_gb"], offset_gb=blob["offset_gb"],
        offset_idx=blob["offset_idx"])
