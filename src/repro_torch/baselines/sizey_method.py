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

``risk`` (a :class:`~repro_torch.core.risk.RiskConfig`, or ``True`` for
the defaults) replaces the retrospective offset with the risk-priced band:
the allocation becomes ``agg + band(tau)``, where the band is the pool's
rolling conformal residual quantile widened by the decision's ensemble
spread, and ``tau`` is priced from the live cluster pressure (fed by the
engine through ``note_pressure``) and the observed crash exposure. Cold
pools and preset decisions run the paper path bitwise, so ``risk=None``
is the method without risk, byte for byte. With risk on,
``failure_strategy="auto"`` lets the cluster engine ask this method for
each task's crash handling (``strategy_for``) and checkpoint cadence
(``checkpoint_frac_for``) per pool, from RAQ x crash exposure.
``quality=True`` emits one prediction-quality row per completion
(:mod:`repro_torch.obs.quality`); ``risk`` one row per repriced decision
(:mod:`repro_torch.obs.risk`). Both ride the provenance stream.

The cluster engine's journal persists the crash counters, the last
pressure sample and the in-flight decisions through the durability hooks
(``export_state`` / ``export_pending`` and their inverses), in the
reference's row layout.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.config import SizeyConfig
from repro_torch.core.predictor import SizeyPredictor, SizingDecision
from repro_torch.core.provenance import ProvenanceDB
from repro_torch.core.risk import RiskConfig, RiskManager, crash_probability
from repro_torch.core.risk import checkpoint_frac_for as _auto_checkpoint_frac
from repro_torch.core.risk import select_strategy as _auto_strategy
from repro_torch.core.temporal.predictor import (TemporalDecision,
                                                 TemporalSizeyPredictor)
from repro_torch.core.temporal.segments import ReservationPlan
from repro_torch.obs.quality import QUALITY_KIND
from repro_torch.obs.risk import RISK_KIND
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
                 quality: bool = False,
                 risk: RiskConfig | bool | None = None, device=None):
        if risk:
            self.risk = RiskManager(risk if isinstance(risk, RiskConfig)
                                    else None)
        else:
            self.risk = None
        if failure_strategy == "auto":
            if self.risk is None:
                raise ValueError("failure_strategy='auto' selects per-pool "
                                 "strategies from the risk signals: it "
                                 "requires risk=...")
        elif failure_strategy not in FAILURE_STRATEGIES:
            raise ValueError(
                f"unknown failure strategy {failure_strategy!r} "
                f"(have {FAILURE_STRATEGIES} + 'auto')")
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
        # prediction-quality telemetry: one aux row per completion, every
        # field a pure function of journal-restorable predictor state read
        # after the observe, so a warm resume regenerates post-kill rows
        # bitwise
        self.quality = quality
        self._clock_h = 0.0
        self._quality_seq = len(self.predictor.db.aux.get(QUALITY_KIND, ()))
        # the engine's last sizing-pressure sample (serial runs never call
        # note_pressure: it stays 0.0 and risk prices generously) and the
        # risk-row counter, which like _quality_seq continues from the
        # warm-start prefix
        self._pressure = 0.0
        self._risk_seq = len(self.predictor.db.aux.get(RISK_KIND, ()))

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
        the scheduling round, a pure function of engine state, so a
        repair-re-executed step samples the identical value. Journaled in
        the method state; the risk layer prices it."""
        self._pressure = float(pressure)

    def note_clock(self, t_h: float) -> None:
        """Engine hook: virtual-clock hours at the completion wave about to
        be observed (stamps the quality and risk rows; serial runs never
        call it, so their rows carry t_h = 0)."""
        self._clock_h = float(t_h)

    def _crash_p(self) -> float:
        """Observed crashes-per-attempt probability (0.0 crash-free)."""
        return crash_probability(self._crash_events, self._exposure_h,
                                 self._runtime_sum_h, self._n_completed)

    def _emit_risk_row(self, d: SizingDecision, tau: float, band: float,
                       crash_p: float, base_alloc: float, alloc: float,
                       collapsed: bool = False) -> None:
        """One ``kind="risk"`` aux row per repriced decision, emitted at
        sizing time, which journal replay never re-enters: a repair-
        re-executed wave regenerates its rows bitwise."""
        self.predictor.db.add_aux(RISK_KIND, {
            "seq": self._risk_seq, "t_h": float(self._clock_h),
            "task_type": d.task_type, "machine": d.machine,
            "tau": float(tau), "band_gb": float(band),
            "pressure": float(self._pressure), "crash_p": float(crash_p),
            "agg_pred_gb": float(d.agg_pred_gb),
            "offset_alloc_gb": float(base_alloc),
            "alloc_gb": float(alloc), "collapsed": int(collapsed)})
        self._risk_seq += 1

    def _risk_alloc(self, decision: SizingDecision,
                    base_alloc: float) -> float:
        """Risk-priced allocation of one flat decision: ``agg + band(tau)``
        clamped to [min_alloc_gb, the task's cap]. Preset decisions and
        cold pools (residual log below ``min_samples``) return
        ``base_alloc`` untouched, bitwise the paper path."""
        d = decision
        if d.source != "model" or d.model_preds is None:
            return base_alloc
        key = (d.task_type, d.machine)
        pool = self.predictor.db.pools.get(key)
        crash_p = self._crash_p()
        tau = self.risk.quantile(self._pressure, crash_p)
        band = self.risk.band(key, pool, tau, d.model_preds)
        if band is None:
            return base_alloc
        cfg = self.predictor.cfg
        alloc = min(max(float(d.agg_pred_gb) + band, cfg.min_alloc_gb),
                    float(d.machine_cap_gb))
        self._emit_risk_row(d, tau, band, crash_p, base_alloc, alloc)
        return alloc

    def _risk_plan(self, decision: TemporalDecision) -> None:
        """Reprice a temporal decision in place: each segment gets
        ``seg_agg + band``, and a plan whose segment values differ by less
        than ``k_collapse_frac`` of the band runs flat (per-pool k = 1).
        ``seg_decisions`` stay as they were (observe credits the segment
        models); the rebuilt plan rides ``export_pending``."""
        peak = decision.peak_decision
        if peak.source != "model" or peak.model_preds is None:
            return
        key = (decision.task_type, decision.machine)
        pool = self.predictor.db.pools.get(key)
        crash_p = self._crash_p()
        tau = self.risk.quantile(self._pressure, crash_p)
        band = self.risk.band(key, pool, tau, peak.model_preds)
        if band is None:
            return
        cfg = self.predictor.cfg
        cap = float(peak.machine_cap_gb)
        base_alloc = decision.allocation_gb
        vals = [min(max(float(sd.agg_pred_gb) + band, cfg.min_alloc_gb), cap)
                for sd in decision.seg_decisions]
        collapsed = self.risk.collapse_temporal(vals, band)
        if collapsed:
            vals = [max(vals)] * len(vals)
        decision.plan = ReservationPlan(tuple(
            (float(end), float(v))
            for (end, _gb), v in zip(decision.plan.segments, vals)))
        self._emit_risk_row(peak, tau, band, crash_p, base_alloc,
                            decision.plan.peak_gb, collapsed)

    def strategy_for(self, task: TaskInstance) -> str:
        """Engine hook (``failure_strategy="auto"``, live sized waves only):
        this task's crash handling from crash exposure x the best RAQ of
        its decision. The engine journals the choice per sized task."""
        d = self._pending[id(task)]
        if self.temporal:
            d = d.peak_decision
        raq = None
        if d.raq is not None and len(d.raq):
            raq = float(np.max(np.asarray(d.raq)))
        return _auto_strategy(self.risk.cfg, self._crash_p(), raq)

    def checkpoint_frac_for(self, task: TaskInstance) -> float:
        """Engine hook (``failure_strategy="auto"``): the checkpoint
        cadence, shorter the crashier the cluster looks. Journaled with
        ``strategy_for``'s choice."""
        return _auto_checkpoint_frac(self.risk.cfg, self._crash_p())

    def allocate(self, task: TaskInstance) -> float:
        """Size one task's first attempt: predict -> crash-aware offset ->
        risk reprice (a temporal method: the peak of the task's plan)."""
        if self.temporal:
            return self.allocate_batch([task])[0]
        decision = self.predictor.predict(
            task.task_type, task.machine, task.features, task.user_preset_gb,
            machine_cap_gb=task.machine_cap_gb)
        self._pending[id(task)] = decision
        alloc = self._crash_aware_alloc(decision)
        if self.risk is not None:
            alloc = self._risk_alloc(decision, alloc)
        return alloc

    def allocate_batch(self, tasks: list[TaskInstance]) -> list[float]:
        """Decide a burst of submissions with one dispatch per pool."""
        decisions = self.predictor.predict_batch(tasks)
        for task, decision in zip(tasks, decisions):
            self._pending[id(task)] = decision
        if self.temporal:
            # a plan is a whole-runtime schedule: the crash-aware offset
            # fold applies to flat (peak) decisions only
            if self.risk is not None:
                for d in decisions:
                    self._risk_plan(d)
            return [d.allocation_gb for d in decisions]
        allocs = [self._crash_aware_alloc(d) for d in decisions]
        if self.risk is not None:
            allocs = [self._risk_alloc(d, a)
                      for d, a in zip(decisions, allocs)]
        return allocs

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
        if self.quality:
            self._record_quality([(decision, task, first_alloc_gb)])

    def complete_batch(self, items) -> None:
        """Observe a wave of simultaneous completions, one observe dispatch
        per pool (``items``: (task, first_alloc_gb, attempts) tuples)."""
        for task, _first, _attempts in items:
            self._note_completion(task)
        completions = [(self._pending.pop(id(task)), task, first, attempts)
                       for task, first, attempts in items]
        if self.temporal:
            self.predictor.observe_batch(
                [(d, task, attempts)
                 for d, task, _first, attempts in completions])
        else:
            self.predictor.observe_batch(
                [(d, task.actual_peak_gb, task.runtime_h, attempts,
                  task.workflow)
                 for d, task, _first, attempts in completions])
        if self.quality:
            self._record_quality([(d, task, first)
                                  for d, task, first, _ in completions])

    def _record_quality(self, triples) -> None:
        """One ``kind="quality"`` aux row per completed task, in completion
        order, after the observe: fit_serial and next_fit_at then read the
        same live and after a warm resume (warm_start rebuilds both)."""
        inner = self.predictor.predictor if self.temporal else self.predictor
        db = self.predictor.db
        models = inner.models
        for decision, task, first_gb in triples:
            d = decision.peak_decision if self.temporal else decision
            key = (d.task_type, d.machine)
            pool = db.pools.get(key)
            peak = float(task.actual_peak_gb)
            err = float(first_gb) - peak
            if d.raq is not None and len(d.raq):
                raq_arr = np.asarray(d.raq)
                idx = int(np.argmax(raq_arr))
                raq = float(raq_arr[idx])
                model = models[idx] if idx < len(models) else str(idx)
                offset, agg = float(d.offset_gb), float(d.agg_pred_gb)
            else:
                raq = model = offset = agg = None
            db.add_aux(QUALITY_KIND, {
                "seq": self._quality_seq, "t_h": float(self._clock_h),
                "task_type": d.task_type, "machine": d.machine,
                "raq": raq, "model": model, "offset_gb": offset,
                "agg_pred_gb": agg, "source": d.source,
                "alloc_gb": float(first_gb), "peak_gb": peak,
                "under": int(float(first_gb) < peak), "err_gb": err,
                "err_frac": err / peak if peak > 0 else 0.0,
                "n_obs": pool.count if pool is not None else 0,
                "fit_serial": int(inner._fit_serial.get(key, 0)),
                "next_fit_at": int(inner._next_fit_at.get(key, 0)),
            })
            self._quality_seq += 1

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
