"""SizeyPredictor — the paper's online memory-prediction engine (§II).

Pipeline per submitted task (paper Fig. 3):
  1  retrieve the (task_type × machine) pool from the provenance DB;
  2.1 every model in the pool predicts;    2.2 RAQ-gated aggregation;
  2.3 dynamic offset;  -> allocation submitted to the resource manager;
  3  on completion, the provenance DB and all models are updated online
     (full retrain or incremental, cfg.incremental).

The decision loop keeps the reference's structure (``repro.core.predictor``)
on one device, CUDA by default:

  * the history lives in device buffers (:mod:`repro_torch.core.provenance`)
    appended in place;
  * ``predict`` is one *dispatch* per pool: all model forwards over the K
    tasks (the MLP through the ensemble-MLP kernel, the k-NN through the
    k-NN kernel), the RAQ gate and the clamp, packed into one (K, 5 + 3N)
    tensor that comes back to the host in ONE device->host copy;
  * ``observe`` fits (or updates) all models, refreshes the in-sample
    predictions over the whole buffer (the kernels again, at CAP rows) and
    recomputes the task-independent half of the decision (accuracy scores,
    alpha, the dynamic offset), which the next predicts read from the cache;
  * ``predict_batch`` decides a burst of same-pool tasks in one dispatch,
    the batch padded to a power-of-two bucket.

``DISPATCH_COUNTS`` counts dispatches per pool and wave as the reference
does; each dispatch launches the two kernels once. ``TRACE_COUNTS`` counts
the distinct shape signatures a dispatch has met, the reference's compile
count (O(log history) per pool: buffers double and batches are bucketed).

``SizeyPredictor(fused=False)`` keeps the reference's pre-fusion per-model
loop, a numerical reference and benchmark baseline: a prediction runs each
model's predict on its own (the MLP's launches K1, the k-NN's K2: N
launches) and one combine (RAQ, gate and offset recomputed over the whole
pool, re-uploaded from the host); an observe fits each model on its own
and refreshes the in-sample predictions through the host. As in the
reference, the loop counts no dispatch in ``DISPATCH_COUNTS``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.config import SizeyConfig
from repro_torch.core.failure import retry_allocation
from repro_torch.core.gating import gate_weights
from repro_torch.core.models import MODEL_MODULES
from repro_torch.core.offsets import retrospective_wastage, select_offset
from repro_torch.core.provenance import ProvenanceDB, TaskRecord
from repro_torch.core.raq import accuracy_score, efficiency_scores, raq_scores
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import span as _span
from repro_torch.utils.misc import device_constant, stable_hash

TRACE_COUNTS: collections.Counter = _obs_metrics.counter(
    "predictor_trace_total", "new dispatch shape signatures by kind")
DISPATCH_COUNTS: collections.Counter = _obs_metrics.counter(
    "predictor_dispatch_total", "fused device dispatches by kind")
_SEEN_SIGNATURES: set = set()

# aux-row kind journaling full-retrain horizons under the amortized-refit
# schedule (cfg.refit_growth > 0), as in the reference
FIT_KIND = "fit"

# candidate grid for the adaptive-alpha extension (paper §III-E future work)
ALPHA_GRID = (0.0, 0.25, 0.5, 0.75, 1.0)


def _note_signature(kind: str, *sig) -> None:
    if (kind, *sig) not in _SEEN_SIGNATURES:
        _SEEN_SIGNATURES.add((kind, *sig))
        TRACE_COUNTS[kind] += 1


def _block(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class SizingDecision:
    """What Sizey decided for one task submission."""
    task_type: str
    machine: str
    features: tuple[float, ...]
    source: str                      # "preset" | "model"
    allocation_gb: float
    user_preset_gb: float
    machine_cap_gb: float
    model_preds: np.ndarray | None = None   # (N_models,)
    raq: np.ndarray | None = None
    weights: np.ndarray | None = None
    agg_pred_gb: float = 0.0
    offset_gb: float = 0.0
    offset_idx: int = -1


@dataclasses.dataclass(frozen=True)
class TaskQuery:
    """One pending submission for :meth:`SizeyPredictor.predict_batch`
    (any object with these attributes is accepted)."""
    task_type: str
    machine: str
    features: tuple[float, ...]
    user_preset_gb: float
    machine_cap_gb: float | None = None


def _select_alpha(acc, log_model_preds, log_actual, log_runtime, log_mask,
                  strategy: str, beta: float, ttf: float):
    """Adaptive alpha: re-gate the LOGGED per-model predictions with each
    candidate alpha and keep the one whose aggregate would have wasted
    least (offset-free replay)."""
    p = log_model_preds.clamp_min(0.0)
    eff_log = 1.0 - p / p.amax(0, keepdim=True).clamp_min(1e-9)   # (N, L)
    max_seen = torch.where(log_mask > 0, log_actual,
                           torch.zeros_like(log_actual)).max()
    alphas = device_constant(ALPHA_GRID, acc.device)
    raq = ((1.0 - alphas)[:, None, None] * acc[None, :, None]
           + alphas[:, None, None] * eff_log[None])                # (A,N,L)
    if strategy == "argmax":
        w = torch.nn.functional.one_hot(raq.argmax(1), raq.shape[1]
                                        ).to(raq.dtype).transpose(1, 2)
    else:
        w = torch.softmax(beta * raq, dim=1)
    agg = (w * log_model_preds[None]).sum(1)                      # (A, L)
    wastes = retrospective_wastage(0.0, agg, log_actual, log_runtime,
                                   log_mask, max_seen, ttf)
    return torch.take(alphas, wastes.argmin())


def _decision_cache_core(cfg: SizeyConfig, ttf: float, insample, ys,
                         runtimes, mask, log_agg, log_actual, log_runtime,
                         log_mask, log_model_preds):
    """The task-INDEPENDENT half of the decision: accuracy scores (Eq. 1),
    the effective alpha and the dynamic offset (§II-E). Depends only on
    pool state, so it is computed at observe time and cached. Returns
    (acc (N,), alpha_eff, offset, offset_idx) as device tensors."""
    acc = accuracy_score(insample, ys, mask)
    alpha = torch.full((), cfg.alpha, dtype=torch.float32, device=acc.device)
    if cfg.adaptive_alpha:
        a = _select_alpha(acc, log_model_preds, log_actual, log_runtime,
                          log_mask, cfg.strategy, cfg.beta, ttf)
        alpha = torch.where(log_mask.sum() >= 5, a, alpha)
    # offset from the prequential aggregate errors; while the log is young
    # (< 5 predictions) also from the in-sample errors of an
    # accuracy-weighted aggregate, so the first model predictions already
    # carry a fault-tolerance offset
    off_log, idx_log = select_offset(log_actual - log_agg, log_agg,
                                     log_actual, log_runtime, log_mask, ttf)
    acc_w = gate_weights(raq_scores(acc, torch.zeros_like(acc), 0.0),
                         cfg.strategy, cfg.beta)
    ins_agg = acc_w @ insample
    off_ins, idx_ins = select_offset(ys - ins_agg, ins_agg, ys, runtimes,
                                     mask, ttf)
    young = log_mask.sum() < 5
    offset = torch.where(young, torch.maximum(off_ins, off_log), off_log)
    off_idx = torch.where(young, idx_ins, idx_log)
    return acc, alpha, offset, off_idx


def _apply_gate(strategy: str, beta: float, model_preds, acc, alpha_eff):
    """The task-DEPENDENT half: ES from the current predictions, RAQ, and
    the gated aggregate (Eq. 2-4), over the last axis."""
    raq = raq_scores(acc, efficiency_scores(model_preds), alpha_eff)
    weights = gate_weights(raq, strategy, beta)
    return (model_preds * weights).sum(-1), raq, weights


def _combine_core(cfg: SizeyConfig, ttf: float, model_preds, insample, ys,
                  runtimes, mask, log_agg, log_actual, log_runtime, log_mask,
                  log_model_preds):
    """RAQ -> gating -> offset (Eq. 1-4 + §II-E) recomputed inline: the
    per-model loop's combine. The fused path splits it into
    ``_decision_cache_core`` (at observe) and ``_apply_gate`` (at
    predict), so the two paths compute the same numbers."""
    acc, alpha, offset, off_idx = _decision_cache_core(
        cfg, ttf, insample, ys, runtimes, mask, log_agg, log_actual,
        log_runtime, log_mask, log_model_preds)
    agg, raq, weights = _apply_gate(cfg.strategy, cfg.beta, model_preds, acc,
                                    alpha)
    return agg, raq, weights, offset, off_idx


# ------------------------------------------------------------------ legacy
# The per-model helpers of the pre-fusion loop (fused=False): one model at
# a time, each predict a launch of its kernel.
def _fit(model: str, cfg: SizeyConfig, xs, ys, mask, rng):
    return MODEL_MODULES[model].fit(xs, ys, mask, rng, cfg)


def _update(model: str, cfg: SizeyConfig, state, xs, ys, mask, new_idx: int,
            rng):
    return MODEL_MODULES[model].update(state, xs, ys, mask, new_idx, rng, cfg)


def _predict_batch(model: str, cfg: SizeyConfig, state,
                   xb: torch.Tensor) -> torch.Tensor:
    """One model over a (K, d) feature block -> (K,)."""
    if model == "knn":
        return MODEL_MODULES[model].predict_batch(state, xb, k=cfg.knn_k)
    return MODEL_MODULES[model].predict_batch(state, xb)


def _predict(model: str, cfg: SizeyConfig, state, x: torch.Tensor):
    """One model at one (d,) feature vector -> a 0-d prediction."""
    return _predict_batch(model, cfg, state, x[None])[0]


def _via_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host and back: the loop's re-upload of the
    pool on every call (the seed implementation's cost model)."""
    return t.cpu().to(t.device)


def _pool_model_preds(models: tuple[str, ...], cfg: SizeyConfig, states,
                      xb: torch.Tensor) -> torch.Tensor:
    """All models' predictions over a (K, d) feature block -> (N, K)."""
    return torch.stack([_predict_batch(m, cfg, states[i], xb)
                        for i, m in enumerate(models)])


def _decide(models, cfg: SizeyConfig, states, xc: torch.Tensor, cache):
    """The whole decision for K same-pool tasks, from the cached
    task-independent half. ``xc`` is (K, d+1): features with the machine
    cap appended. Returns (K, 5 + 3N) rows of
    [allocation, agg, offset, offset_idx, best_model, preds, raq, weights].
    """
    acc, alpha_eff, offset, off_idx = cache
    xb, caps = xc[:, :-1], xc[:, -1]
    p = _pool_model_preds(models, cfg, states, xb).T            # (K, N)
    agg, raq, weights = _apply_gate(cfg.strategy, cfg.beta, p, acc,
                                    alpha_eff)
    alloc = torch.minimum((agg + offset).clamp_min(cfg.min_alloc_gb), caps)
    k = xc.shape[0]
    head = torch.stack([alloc, agg, offset.expand(k),
                        off_idx.to(torch.float32).expand(k),
                        raq.argmax(-1).to(torch.float32)], 1)
    return torch.cat([head, p, raq, weights], 1)


def _batch_bucket(k: int) -> int:
    """Round a batch size up to the next power of two."""
    b = 1
    while b < k:
        b *= 2
    return b


class SizeyPredictor:
    """Online multi-model memory predictor (the paper's contribution),
    on ``device`` (CUDA by default; ``device="cpu"`` runs the plain PyTorch
    versions of the kernels). ``fused=True`` (default) runs the
    single-dispatch decision loop; ``fused=False`` the per-model loop."""

    def __init__(self, cfg: SizeyConfig | None = None,
                 db: ProvenanceDB | None = None, *, n_features: int = 1,
                 ttf: float = 1.0, default_machine_cap_gb: float = 128.0,
                 fused: bool = True, device=None):
        self.cfg = cfg or SizeyConfig()
        self.n_features = n_features
        self.models = tuple(self.cfg.model_classes)
        self.db = db or ProvenanceDB(n_features=n_features,
                                     n_models=len(self.models),
                                     device=device)
        if device is not None and torch.device(device) != self.db.device:
            raise ValueError(f"predictor device {device} differs from the "
                             f"provenance DB's {self.db.device}")
        self.device = self.db.device
        self.ttf = float(ttf)
        self.default_machine_cap_gb = default_machine_cap_gb
        self.fused = fused
        # per-pool model states: key -> tuple of states in self.models order
        self.states: dict[tuple[str, str], tuple] = {}
        # per-pool decision cache (acc, alpha_eff, offset, offset_idx)
        self._cache: dict[tuple[str, str], tuple] = {}
        self._fit_serial: dict[tuple[str, str], int] = {}
        # amortized-refit bookkeeping (cfg.refit_growth > 0)
        self._next_fit_at: dict[tuple[str, str], int] = {}
        self._fit_cap: dict[tuple[str, str], int] = {}
        self.train_times_s: list[float] = []
        self.model_select_counts = np.zeros(len(self.models), np.int64)

    # ------------------------------------------------------------- predict
    def predict(self, task_type: str, machine: str, features,
                user_preset_gb: float,
                machine_cap_gb: float | None = None) -> SizingDecision:
        """Size one task: ensemble predict -> RAQ gate -> offset -> clamp.
        Pools younger than ``cfg.min_history`` return the user preset."""
        cap_gb = (self.default_machine_cap_gb if machine_cap_gb is None
                  else machine_cap_gb)
        feats = tuple(float(f) for f in np.atleast_1d(features))
        pool = self.db.pool(task_type, machine)
        key = (task_type, machine)
        if pool.count < self.cfg.min_history or key not in self.states:
            return self._preset_decision(task_type, machine, feats,
                                         user_preset_gb, cap_gb)
        if not self.fused:
            return self._predict_loop(key, pool, feats, user_preset_gb,
                                      cap_gb)
        return self._predict_pool(
            key, pool, np.asarray([feats], np.float32),
            np.asarray([cap_gb], np.float32), [user_preset_gb])[0]

    def predict_batch(self, tasks) -> list[SizingDecision]:
        """Decide a burst of submissions: one dispatch per pool, decisions
        in submission order, numerically those of :meth:`predict`."""
        out: list[SizingDecision | None] = [None] * len(tasks)
        groups: dict[tuple[str, str], list[int]] = {}
        for i, t in enumerate(tasks):
            groups.setdefault((t.task_type, t.machine), []).append(i)
        for key, idxs in groups.items():
            pool = self.db.pool(*key)
            caps = np.asarray(
                [self.default_machine_cap_gb
                 if getattr(tasks[i], "machine_cap_gb", None) is None
                 else tasks[i].machine_cap_gb for i in idxs], np.float32)
            presets = [float(tasks[i].user_preset_gb) for i in idxs]
            featrows = [tuple(float(f) for f in
                              np.atleast_1d(tasks[i].features))
                        for i in idxs]
            if pool.count < self.cfg.min_history or key not in self.states:
                for j, i in enumerate(idxs):
                    out[i] = self._preset_decision(key[0], key[1],
                                                   featrows[j], presets[j],
                                                   float(caps[j]))
            elif not self.fused:
                for j, i in enumerate(idxs):
                    out[i] = self._predict_loop(key, pool, featrows[j],
                                                presets[j], float(caps[j]))
            else:
                xb = np.asarray(featrows, np.float32)
                for i, d in zip(idxs, self._predict_pool(key, pool, xb, caps,
                                                         presets)):
                    out[i] = d
        return out  # type: ignore[return-value]

    @staticmethod
    def _preset_decision(task_type: str, machine: str, feats,
                         user_preset_gb: float,
                         cap_gb: float) -> SizingDecision:
        """Cold pool / young task type: the user preset, clamped to the
        machine cap (§I)."""
        return SizingDecision(task_type, machine, feats, "preset",
                              min(user_preset_gb, cap_gb), user_preset_gb,
                              cap_gb)

    def _predict_pool(self, key, pool, xb: np.ndarray, caps: np.ndarray,
                      presets) -> list[SizingDecision]:
        """One dispatch deciding K tasks of one pool: one upload in, one
        device->host copy out."""
        k = xb.shape[0]
        kpad = _batch_bucket(k)
        if kpad != k:
            xb = np.concatenate([xb, np.repeat(xb[-1:], kpad - k, axis=0)])
            caps = np.concatenate([caps, np.repeat(caps[-1:], kpad - k)])
        xc = torch.from_numpy(np.concatenate([xb, caps[:, None]], axis=1))
        _note_signature("predict", self.models, self.cfg, kpad, xb.shape[1],
                        pool.cap)
        DISPATCH_COUNTS["predict_pool"] += 1
        DISPATCH_COUNTS["decisions"] += k
        with _span("predict", pool=f"{key[0]}@{key[1]}", k=k):
            out = _decide(self.models, self.cfg, self.states[key],
                          xc.to(self.device), self._cache[key]).cpu().numpy()
        n = len(self.models)
        decisions = []
        for j in range(k):
            row = out[j]
            self.model_select_counts[int(row[4])] += 1
            decisions.append(SizingDecision(
                key[0], key[1], tuple(float(v) for v in xb[j]), "model",
                float(row[0]), float(presets[j]), float(caps[j]),
                model_preds=row[5:5 + n], raq=row[5 + n:5 + 2 * n],
                weights=row[5 + 2 * n:5 + 3 * n],
                agg_pred_gb=float(row[1]), offset_gb=float(row[2]),
                offset_idx=int(row[3])))
        return decisions

    def _predict_loop(self, key, pool, feats, user_preset_gb: float,
                      cap_gb: float) -> SizingDecision:
        """Pre-fusion reference: one predict per model (each a launch of
        its kernel on the card) and a combine over the whole pool,
        re-uploaded from the host on every prediction."""
        x = torch.tensor(feats, dtype=torch.float32, device=self.device)
        preds = torch.stack([_predict(m, self.cfg, self.states[key][i], x)
                             for i, m in enumerate(self.models)])
        agg, raq, weights, offset, off_idx = _combine_core(
            self.cfg, self.ttf, preds, *map(_via_host, (
                pool.insample_preds, pool.ys, pool.runtimes, pool.mask,
                pool.log_agg, pool.log_actual, pool.log_runtime,
                pool.log_mask, pool.log_model_preds)))
        alloc = float(np.clip(float(agg) + float(offset),
                              self.cfg.min_alloc_gb, cap_gb))
        raq = raq.cpu().numpy()
        self.model_select_counts[int(np.argmax(raq))] += 1
        return SizingDecision(key[0], key[1], tuple(feats), "model", alloc,
                              user_preset_gb, cap_gb,
                              model_preds=preds.cpu().numpy(), raq=raq,
                              weights=weights.cpu().numpy(),
                              agg_pred_gb=float(agg),
                              offset_gb=float(offset),
                              offset_idx=int(off_idx))

    # ------------------------------------------------------------- failure
    def retry_allocation(self, decision: SizingDecision, attempt: int,
                         last_alloc_gb: float) -> float:
        """Retry-ladder step after an OOM kill (pure host arithmetic)."""
        pool = self.db.pool(decision.task_type, decision.machine)
        return retry_allocation(attempt, last_alloc_gb, pool.max_seen_gb,
                                decision.machine_cap_gb)

    # ------------------------------------------------------------- observe
    def observe(self, decision: SizingDecision, peak_mem_gb: float,
                runtime_h: float, attempts: int = 1,
                workflow: str = "") -> None:
        """Task completed: update provenance, prequential log, and models."""
        key = (decision.task_type, decision.machine)
        self.db.add(TaskRecord(decision.task_type, decision.machine,
                               decision.features, float(peak_mem_gb),
                               float(runtime_h), attempts, workflow))
        pool = self.db.pool(*key)
        if decision.source == "model":
            self.db.add_log(decision.task_type, decision.machine,
                            decision.model_preds, decision.agg_pred_gb,
                            float(peak_mem_gb), float(runtime_h))
        if pool.count < self.cfg.min_history:
            return
        t0 = time.perf_counter()
        serial = self._fit_serial.get(key, 0)
        seed = (stable_hash(f"{key}") + serial + self.cfg.seed) % (2**31)
        if not self.fused:
            self._observe_loop(key, pool, seed)
        else:
            self._maybe_refit(key, pool, seed)
        self._fit_serial[key] = serial + 1
        self.train_times_s.append(time.perf_counter() - t0)

    def observe_batch(self, observations) -> None:
        """Observe a wave of completions with ONE observe dispatch per pool
        (``observations``: (decision, peak_mem_gb, runtime_h, attempts,
        workflow) tuples in completion order). In full-retrain mode the
        refit is seeded as the last of the sequential fits, so the result
        is that of observing one by one; incremental mode and the per-model
        loop observe one by one."""
        if not self.fused or self.cfg.incremental:
            for decision, peak, rt, attempts, workflow in observations:
                self.observe(decision, peak, rt, attempts, workflow)
            return
        groups: dict[tuple[str, str], list] = {}
        for obs in observations:
            d = obs[0]
            groups.setdefault((d.task_type, d.machine), []).append(obs)
        for key, obs_list in groups.items():
            pool = self.db.pool(*key)
            c0 = pool.count
            for decision, peak, rt, attempts, workflow in obs_list:
                self.db.add(TaskRecord(key[0], key[1], decision.features,
                                       float(peak), float(rt), attempts,
                                       workflow))
                if decision.source == "model":
                    self.db.add_log(key[0], key[1], decision.model_preds,
                                    decision.agg_pred_gb, float(peak),
                                    float(rt))
            # record j (1-based) of the wave fits iff c0 + j >= min_history
            n = len(obs_list)
            m = n - max(0, min(self.cfg.min_history - c0 - 1, n))
            if m <= 0:
                continue
            t0 = time.perf_counter()
            serial = self._fit_serial.get(key, 0)
            seed = (stable_hash(f"{key}") + serial + (m - 1)
                    + self.cfg.seed) % (2**31)
            self._maybe_refit(key, pool, seed)
            self._fit_serial[key] = serial + m
            self.train_times_s.append(time.perf_counter() - t0)

    def warm_start(self) -> None:
        """Refit every pool restored from a JSONL checkpoint so prediction
        resumes warm, with the seed of the original's last fit; under the
        amortized-refit schedule the journaled fit horizon is replayed and
        one refresh runs over the full buffers (see the reference)."""
        stride = (self.fused and not self.cfg.incremental
                  and self.cfg.refit_growth > 0.0)
        for key, pool in self.db.pools.items():
            if pool.count < self.cfg.min_history or key in self.states:
                continue
            m = max(pool.count - self.cfg.min_history + 1,
                    self._fit_serial.get(key, 0) + 1)
            c_f = self._last_fit_count(key, pool) if stride else pool.count
            seed = (stable_hash(f"{key}") + (c_f - self.cfg.min_history)
                    + self.cfg.seed) % (2**31)
            if not self.fused:
                self._observe_loop(key, pool, seed)
            elif c_f < pool.count:
                trunc = torch.zeros(pool.cap, dtype=torch.float32,
                                    device=self.device)
                trunc[:c_f] = 1.0
                self._refit_fused(key, pool, seed, mask=trunc)
                self._refresh(key, pool)
            else:
                self._refit_fused(key, pool, seed)
            self._fit_serial[key] = m
            if stride:
                self._fit_cap[key] = pool.cap
                self._next_fit_at[key] = c_f + max(
                    1, math.ceil(self.cfg.refit_growth * c_f))

    def _maybe_refit(self, key, pool, seed: int) -> None:
        """Retrain on every observe (``refit_growth == 0``, the paper's
        loop) or, with ``refit_growth = r > 0``, only once the history grew
        by the fraction r since the last fit or the buffers grew; in
        between, one refresh recomputes the in-sample predictions and the
        decision cache against the existing states."""
        if (self.cfg.refit_growth <= 0.0 or self.cfg.incremental
                or key not in self.states
                or self._fit_cap.get(key) != pool.cap
                or pool.count >= self._next_fit_at.get(key, 0)):
            self._refit_fused(key, pool, seed)
            self._note_fit(key, pool)
            return
        self._refresh(key, pool)

    def _refresh(self, key, pool) -> None:
        """In-sample refresh + decision cache against the existing states:
        one dispatch, no training."""
        _note_signature("refresh", self.models, self.cfg, pool.cap,
                        pool.log_cap)
        DISPATCH_COUNTS["refresh_pool"] += 1
        with _span("refresh", pool=f"{key[0]}@{key[1]}", n=pool.count):
            insample = _pool_model_preds(self.models, self.cfg,
                                         self.states[key], pool.xs)
            self._cache[key] = _decision_cache_core(
                self.cfg, self.ttf, insample, pool.ys, pool.runtimes,
                pool.mask, pool.log_agg, pool.log_actual, pool.log_runtime,
                pool.log_mask, pool.log_model_preds)
            pool.insample_preds = insample
            _block(self.device)

    def _note_fit(self, key, pool) -> None:
        self._fit_cap[key] = pool.cap
        self._next_fit_at[key] = pool.count + max(
            1, math.ceil(self.cfg.refit_growth * pool.count))
        if self.cfg.refit_growth > 0.0 and not self.cfg.incremental:
            # journal the fit horizon so a restore replays the exact fit
            self.db.add_aux(FIT_KIND, {"task_type": key[0],
                                       "machine": key[1],
                                       "count": pool.count})

    def _last_fit_count(self, key, pool) -> int:
        """The history count of the newest journaled full retrain of this
        pool (the full count for checkpoints without one)."""
        c_f = pool.count
        for row in self.db.aux.get(FIT_KIND, ()):
            if (row["task_type"], row["machine"]) == key:
                c_f = int(row["count"])
        return min(c_f, pool.count)

    def _refit_fused(self, key, pool, seed: int, mask=None) -> None:
        """One dispatch: all-model fit/update + in-sample refresh +
        decision cache. ``mask`` overrides the pool mask (warm-start
        reconstruction of a fit that predates the newest records)."""
        incremental = key in self.states and self.cfg.incremental
        kind = "update" if incremental else "fit"
        _note_signature(kind, self.models, self.cfg, pool.cap, pool.log_cap)
        DISPATCH_COUNTS["observe_pool"] += 1
        mask = pool.mask if mask is None else mask
        rng = prng.prng_key(seed)
        with _span("observe", pool=f"{key[0]}@{key[1]}", n=pool.count):
            if incremental:
                states = tuple(
                    MODEL_MODULES[m].update(self.states[key][i], pool.xs,
                                            pool.ys, mask, pool.count - 1,
                                            rng, self.cfg)
                    for i, m in enumerate(self.models))
            else:
                states = tuple(MODEL_MODULES[m].fit(pool.xs, pool.ys, mask,
                                                    rng, self.cfg)
                               for m in self.models)
            insample = _pool_model_preds(self.models, self.cfg, states,
                                         pool.xs)
            self._cache[key] = _decision_cache_core(
                self.cfg, self.ttf, insample, pool.ys, pool.runtimes, mask,
                pool.log_agg, pool.log_actual, pool.log_runtime,
                pool.log_mask, pool.log_model_preds)
            self.states[key] = states
            pool.insample_preds = insample
            _block(self.device)

    def _observe_loop(self, key, pool, seed: int) -> None:
        """Pre-fusion reference: a fit (or update) per model on the pool
        re-uploaded from the host, then the in-sample refresh stacked on
        the host, one predict per model over the buffer."""
        xs, ys, mask = map(_via_host, (pool.xs, pool.ys, pool.mask))
        rng = prng.prng_key(seed)
        if key not in self.states or not self.cfg.incremental:
            states = tuple(_fit(m, self.cfg, xs, ys, mask, rng)
                           for m in self.models)
        else:
            states = tuple(_update(m, self.cfg, self.states[key][i], xs, ys,
                                   mask, pool.count - 1, rng)
                           for i, m in enumerate(self.models))
        self.states[key] = states
        pool.insample_preds = torch.stack([
            _predict_batch(m, self.cfg, states[i], xs).cpu()
            for i, m in enumerate(self.models)]).to(self.device)
        _block(self.device)
