"""TemporalSizeyPredictor — k-segment memory-over-time prediction on top of
the fused Sizey ensemble (the reference's
``repro.core.temporal.predictor``).

  * **Segment boundaries** per (task_type, machine) pool are fit by the
    change-point sweep over the pool's observed usage profiles
    (:func:`repro_torch.core.temporal.segments.fit_boundaries`, one launch
    of the segment-DP kernel on a CUDA device), cached per pool
    generation. With fewer than 3 profiles the k segments are uniform.
  * **Per-segment peaks ride the existing ensemble.** Each segment is one
    row of the inner :class:`SizeyPredictor`'s feature space — the base
    task features plus the segment's center time fraction — so a wave's
    K·k segment queries cost one dispatch per pool.
  * **k = 1 is the peak predictor, bitwise.** No segment feature, no
    ``min_history`` scaling, and a one-segment plan the engines run on the
    flat path.
  * **Persistence**: the inner provenance JSONL carries the per-segment
    records and prequential log; grid-sampled usage profiles ride the same
    file as ``kind="curve"`` aux rows, in the reference's format, so a
    checkpoint either package writes restores warm in the other.

``min_history`` is scaled by k for the inner predictor (each completion
contributes k rows), and for k > 1 the inner ensemble retrains on the
amortized stride ``TEMPORAL_REFIT_GROWTH``.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core.config import SizeyConfig
from repro_torch.core.predictor import (SizeyPredictor, SizingDecision,
                                        TaskQuery)
from repro_torch.core.provenance import ProvenanceDB
from repro_torch.core.temporal.segments import (PROFILE_WINDOW,
                                                ReservationPlan,
                                                fit_boundaries, grid_profile,
                                                segment_peaks,
                                                uniform_boundaries)
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import span as _span

__all__ = ["TemporalDecision", "TemporalSizeyPredictor"]

# aux-row kind for usage profiles in the provenance JSONL (the file keeps
# every row; restore re-trims to the shared PROFILE_WINDOW)
CURVE_KIND = "curve"

# amortized-refit growth factor passed to the inner SizeyPredictor for
# k > 1 (see SizeyConfig.refit_growth); k = 1 keeps the every-observe fit
TEMPORAL_REFIT_GROWTH = 0.25

# boundary-fit accounting, as the reference's: "fit" counts change-point
# sweeps run, "hit" cache servings, "uniform" no-history defaults
BOUNDARY_COUNTS: collections.Counter = _obs_metrics.counter(
    "temporal_boundary_total", "segment-boundary fit events by kind")


@dataclasses.dataclass
class TemporalDecision:
    """What the temporal predictor decided for one task submission: one
    sizing decision per segment, stitched into a reservation plan."""
    task_type: str
    machine: str
    boundaries: tuple[float, ...]          # segment end fractions
    seg_decisions: list[SizingDecision]    # one per segment, same order
    plan: ReservationPlan

    @property
    def allocation_gb(self) -> float:
        """What a plan-unaware engine should reserve: the plan peak."""
        return self.plan.peak_gb

    @property
    def source(self) -> str:
        return self.seg_decisions[0].source

    @property
    def peak_decision(self) -> SizingDecision:
        """The segment decision carrying the plan's peak (drives the
        retry ladder)."""
        return max(self.seg_decisions, key=lambda d: d.allocation_gb)


class TemporalSizeyPredictor:
    """k-segment piecewise-constant memory-over-time predictor composed
    from the Sizey ensemble, on ``device`` (CUDA unless the caller asks
    for another; see the module docstring)."""

    def __init__(self, cfg: SizeyConfig | None = None, *,
                 k_segments: int = 4, n_grid: int = 32,
                 n_features: int = 1, ttf: float = 1.0,
                 default_machine_cap_gb: float = 128.0,
                 persist_path: str | None = None, fused: bool = True,
                 refit_growth: float | None = None, device=None):
        if k_segments < 1:
            raise ValueError("k_segments must be >= 1")
        if n_grid < k_segments:
            raise ValueError("n_grid must be >= k_segments")
        cfg = cfg or SizeyConfig()
        self.k = int(k_segments)
        self.n_grid = int(n_grid)
        self.base_features = int(n_features)
        # k=1: no segment feature, no min_history scaling, no refit stride
        inner_features = n_features + (1 if self.k > 1 else 0)
        if self.k > 1:
            inner_cfg = dataclasses.replace(
                cfg, min_history=cfg.min_history * self.k,
                refit_growth=(TEMPORAL_REFIT_GROWTH if refit_growth is None
                              else float(refit_growth)))
        elif refit_growth is not None:
            inner_cfg = dataclasses.replace(
                cfg, refit_growth=float(refit_growth))
        else:
            inner_cfg = cfg
        db = ProvenanceDB(n_features=inner_features,
                          n_models=len(cfg.model_classes),
                          persist_path=persist_path, device=device)
        self.predictor = SizeyPredictor(
            inner_cfg, db, n_features=inner_features, ttf=ttf,
            default_machine_cap_gb=default_machine_cap_gb, fused=fused)
        self.cfg = inner_cfg
        self.device = db.device
        # host-side pool state: grid-sampled usage profiles and the
        # boundary fits, cached by pool GENERATION (bumped on every observe
        # of the pool): one fit per (pool, generation)
        self._profiles: dict[tuple[str, str], list[np.ndarray]] = {}
        self._gen: dict[tuple[str, str], int] = {}
        self._boundaries: dict[tuple[str, str],
                               tuple[int, tuple[float, ...]]] = {}
        # checkpoint restore: replay profiles, rebuild model states and
        # decision caches, and pre-fit the boundary cache
        for row in db.aux.get(CURVE_KIND, ()):
            self._profiles.setdefault(
                (row["task_type"], row["machine"]), []).append(
                    np.asarray(row["profile"], np.float64))
        for profs in self._profiles.values():
            del profs[:-PROFILE_WINDOW]
        if db.records:
            self.predictor.warm_start()
        for key in self._profiles:
            self._fit_pool(key)

    @property
    def db(self) -> ProvenanceDB:
        return self.predictor.db

    # --------------------------------------------------------- boundaries
    def _fit_pool(self, key: tuple[str, str]) -> tuple[float, ...]:
        """Fit (or default) the pool's boundaries and cache them under its
        current generation."""
        profs = self._profiles.get(key)
        if not profs or len(profs) < 3:
            bounds = uniform_boundaries(self.k)
            BOUNDARY_COUNTS["uniform"] += 1
        else:
            with _span("boundary_fit", pool=f"{key[0]}@{key[1]}",
                       n=len(profs)):
                bounds = fit_boundaries(np.stack(profs), self.k,
                                        device=self.device)
            BOUNDARY_COUNTS["fit"] += 1
        self._boundaries[key] = (self._gen.get(key, 0), bounds)
        return bounds

    def boundaries(self, task_type: str, machine: str) -> tuple[float, ...]:
        """Current segment end fractions for one pool, served from the
        generation-keyed cache."""
        if self.k == 1:
            return (1.0,)
        key = (task_type, machine)
        cached = self._boundaries.get(key)
        if cached is not None and cached[0] == self._gen.get(key, 0):
            BOUNDARY_COUNTS["hit"] += 1
            return cached[1]
        return self._fit_pool(key)

    def _seg_features(self, feats: tuple[float, ...],
                      bounds: tuple[float, ...]) -> list[tuple[float, ...]]:
        if self.k == 1:
            return [feats]
        rows, prev = [], 0.0
        for end in bounds:
            rows.append(feats + (0.5 * (prev + end),))
            prev = end
        return rows

    # ------------------------------------------------------------ predict
    def predict_batch(self, tasks) -> list[TemporalDecision]:
        """Decide a burst of submissions: every segment of every task is
        one row of a single inner ``predict_batch`` call, one dispatch per
        pool."""
        queries: list[TaskQuery] = []
        metas = []
        for t in tasks:
            bounds = self.boundaries(t.task_type, t.machine)
            feats = tuple(float(f) for f in np.atleast_1d(t.features))
            cap = getattr(t, "machine_cap_gb", None)
            for row in self._seg_features(feats, bounds):
                queries.append(TaskQuery(t.task_type, t.machine, row,
                                         float(t.user_preset_gb), cap))
            metas.append((t, bounds))
        decisions = self.predictor.predict_batch(queries)
        out: list[TemporalDecision] = []
        pos = 0
        for t, bounds in metas:
            segs = decisions[pos:pos + len(bounds)]
            pos += len(bounds)
            plan = ReservationPlan(tuple(
                (end, d.allocation_gb) for end, d in zip(bounds, segs)))
            out.append(TemporalDecision(t.task_type, t.machine, bounds,
                                        segs, plan))
        return out

    def predict(self, task) -> TemporalDecision:
        return self.predict_batch([task])[0]

    # ------------------------------------------------------------- failure
    def retry_allocation(self, decision: TemporalDecision, attempt: int,
                         last_alloc_gb: float) -> float:
        """Retries are flat: the ladder climbs from the pool's max seen
        segment peak, as the peak predictor's does."""
        return self.predictor.retry_allocation(decision.peak_decision,
                                               attempt, last_alloc_gb)

    # ------------------------------------------------------------- observe
    def observe_batch(self, completions) -> None:
        """Observe completed tasks (``(decision, task, attempts)``): append
        each task's grid profile (a ``curve`` aux row), take its segment
        peaks under the boundaries the decision was made with, and feed
        every segment observation of the wave to the inner
        ``observe_batch`` — one dispatch per pool."""
        obs = []
        for decision, task, attempts in completions:
            key = (decision.task_type, decision.machine)
            profile = grid_profile(task.usage_curve, self.n_grid,
                                   peak_gb=task.actual_peak_gb)
            if self.k > 1:
                profs = self._profiles.setdefault(key, [])
                profs.append(profile)
                del profs[:-PROFILE_WINDOW]       # bounded fit window
                # a new generation: the cached boundary fit is stale
                self._gen[key] = self._gen.get(key, 0) + 1
                self.db.add_aux(CURVE_KIND, {
                    "task_type": key[0], "machine": key[1],
                    "profile": [float(v) for v in profile]})
                peaks = segment_peaks(profile, decision.boundaries)
            else:
                peaks = np.asarray([task.actual_peak_gb])
            for d, seg_peak in zip(decision.seg_decisions, peaks):
                obs.append((d, float(seg_peak), float(task.runtime_h),
                            attempts, task.workflow))
        self.predictor.observe_batch(obs)

    def observe(self, decision: TemporalDecision, task,
                attempts: int = 1) -> None:
        self.observe_batch([(decision, task, attempts)])
