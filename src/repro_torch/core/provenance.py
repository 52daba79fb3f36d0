"""Provenance database (paper Fig. 3, phase 1/3), with device buffers.

Completed task executions are stored per (task_type, machine) key in
fixed-capacity masked torch buffers on one device, which grow
geometrically (``INITIAL_CAP`` rows, doubling), plus the *prequential*
prediction log used by the accuracy score and the offset selector. An
append writes one row in place with scalar fills, so the hot path never
copies the history between host and device; host-side scalars (count,
capacity, the largest peak seen) let the scheduler branch without reading
the device.

Persistence is the reference's JSONL format byte for byte (task records,
``{"kind": "log"}`` prequential rows, and any other ``kind`` as opaque aux
rows), so a checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Iterator

import numpy as np
import torch

from repro_torch.utils.misc import resolve_device

INITIAL_CAP = 128
# doubling keeps at most 2x padding in every masked computation over the
# buffers and O(log history) distinct buffer shapes
GROWTH = 2


def read_jsonl_lines(path: str) -> tuple[list[str], bool]:
    """Read a checkpoint JSONL as raw lines, tolerating a torn FINAL line
    (the one failure mode of a crash mid-append on a POSIX filesystem:
    appends are sequential, so only the last record can be partial).
    Returns ``(intact_lines, truncated)``. A malformed line anywhere BUT
    the end is real corruption and raises — silently skipping it would
    desynchronize the predictor history from the journal."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    truncated = False
    if lines:
        try:
            json.loads(lines[-1])
        except json.JSONDecodeError:
            lines = lines[:-1]
            truncated = True
    for i, ln in enumerate(lines):
        try:
            json.loads(ln)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path}: corrupt (non-final) checkpoint line {i + 1}: "
                f"{e}") from None
    return lines, truncated


@dataclasses.dataclass
class TaskRecord:
    """One completed task execution."""
    task_type: str
    machine: str
    features: tuple[float, ...]   # e.g. (input_size_gb,)
    peak_mem_gb: float
    runtime_h: float
    attempts: int = 1
    workflow: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(line: str) -> "TaskRecord":
        d = json.loads(line)
        d["features"] = tuple(d["features"])
        return TaskRecord(**d)


def _cap_for(n: int) -> int:
    """Smallest geometric-growth capacity holding n rows."""
    cap = INITIAL_CAP
    while cap < n:
        cap *= GROWTH
    return cap


def _pad_rows(t: torch.Tensor, new_rows: int, axis: int = 0) -> torch.Tensor:
    shape = list(t.shape)
    shape[axis] = new_rows
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out.narrow(axis, 0, t.shape[axis]).copy_(t)
    return out


def _padded(host: np.ndarray, cap: int, device, axis: int = 0
            ) -> torch.Tensor:
    out = np.zeros((*host.shape[:axis], cap, *host.shape[axis + 1:]),
                   np.float32)
    out[(slice(None),) * axis + (slice(0, host.shape[axis]),)] = host
    return torch.from_numpy(out).to(device)


class _PoolBuffers:
    """Masked, geometrically growing device buffers for one
    (task_type, machine). Tensors live on ``device``; count, capacity and
    max_seen_gb stay on the host."""

    def __init__(self, n_features: int, n_models: int, device):
        self.device = device
        self.cap = INITIAL_CAP
        self.count = 0
        self.n_models = n_models
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        self.xs = z(self.cap, n_features)
        self.ys = z(self.cap)
        self.runtimes = z(self.cap)
        self.mask = z(self.cap)
        # per-model in-sample predictions over the buffer, refreshed after
        # every fit/update — feeds the accuracy score (Eq. 1)
        self.insample_preds = z(n_models, self.cap)
        # prequential prediction log (only rows where Sizey really predicted)
        self.log_cap = INITIAL_CAP
        self.log_count = 0
        self.log_model_preds = z(n_models, self.log_cap)
        self.log_agg = z(self.log_cap)
        self.log_actual = z(self.log_cap)
        self.log_runtime = z(self.log_cap)
        self.log_mask = z(self.log_cap)
        self.max_seen_gb = 0.0

    def add(self, features, y: float, runtime_h: float) -> int:
        if self.count == self.cap:
            self.cap *= GROWTH
            self.xs = _pad_rows(self.xs, self.cap)
            self.ys = _pad_rows(self.ys, self.cap)
            self.runtimes = _pad_rows(self.runtimes, self.cap)
            self.mask = _pad_rows(self.mask, self.cap)
            self.insample_preds = _pad_rows(self.insample_preds, self.cap,
                                            axis=1)
        i = self.count
        # scalar fills: no host->device copy that would wait on the stream
        for j, f in enumerate(np.asarray(features, np.float32).ravel()):
            self.xs[i, j] = float(f)
        self.ys[i] = float(y)
        self.runtimes[i] = float(runtime_h)
        self.mask[i] = 1.0
        self.count += 1
        self.max_seen_gb = max(self.max_seen_gb, float(y))
        return i

    def bulk_load(self, feats: np.ndarray, ys: np.ndarray,
                  rts: np.ndarray) -> None:
        """Checkpoint restore: upload a whole history at once. Fresh
        pools only."""
        n = len(ys)
        if n == 0:
            return
        assert self.count == 0, "bulk_load on a non-empty pool"
        self.cap = _cap_for(n)
        dev = self.device
        self.xs = _padded(np.asarray(feats, np.float32), self.cap, dev)
        self.ys = _padded(np.asarray(ys, np.float32), self.cap, dev)
        self.runtimes = _padded(np.asarray(rts, np.float32), self.cap, dev)
        self.mask = _padded(np.ones((n,), np.float32), self.cap, dev)
        self.insample_preds = torch.zeros((self.n_models, self.cap),
                                          dtype=torch.float32, device=dev)
        self.count = n
        self.max_seen_gb = float(np.max(ys))  # before the float32 cast

    def bulk_load_log(self, model_preds: np.ndarray, aggs: np.ndarray,
                      actuals: np.ndarray, rts: np.ndarray) -> None:
        """Checkpoint restore of the prequential log, one upload per pool."""
        n = len(aggs)
        if n == 0:
            return
        assert self.log_count == 0, "bulk_load_log on a non-empty log"
        self.log_cap = _cap_for(n)
        dev = self.device
        self.log_model_preds = _padded(np.asarray(model_preds, np.float32),
                                       self.log_cap, dev, axis=1)
        self.log_agg = _padded(np.asarray(aggs, np.float32), self.log_cap,
                               dev)
        self.log_actual = _padded(np.asarray(actuals, np.float32),
                                  self.log_cap, dev)
        self.log_runtime = _padded(np.asarray(rts, np.float32),
                                   self.log_cap, dev)
        self.log_mask = _padded(np.ones((n,), np.float32), self.log_cap, dev)
        self.log_count = n

    def add_log(self, model_preds, agg: float, actual: float,
                runtime_h: float) -> None:
        if self.log_count == self.log_cap:
            self.log_cap *= GROWTH
            self.log_model_preds = _pad_rows(self.log_model_preds,
                                             self.log_cap, axis=1)
            self.log_agg = _pad_rows(self.log_agg, self.log_cap)
            self.log_actual = _pad_rows(self.log_actual, self.log_cap)
            self.log_runtime = _pad_rows(self.log_runtime, self.log_cap)
            self.log_mask = _pad_rows(self.log_mask, self.log_cap)
        j = self.log_count
        for i, p in enumerate(np.asarray(model_preds, np.float32).ravel()):
            self.log_model_preds[i, j] = float(p)
        self.log_agg[j] = float(agg)
        self.log_actual[j] = float(actual)
        self.log_runtime[j] = float(runtime_h)
        self.log_mask[j] = 1.0
        self.log_count += 1


class ProvenanceDB:
    """All task history, keyed by (task_type, machine), on one device
    (CUDA unless ``device`` says otherwise)."""

    def __init__(self, n_features: int = 1, n_models: int = 4,
                 persist_path: str | None = None, *, device=None):
        self.device = resolve_device(device)
        self.n_features = n_features
        self.n_models = n_models
        self.pools: dict[tuple[str, str], _PoolBuffers] = {}
        self.records: list[TaskRecord] = []
        # non-core checkpoint rows restored from the JSONL, grouped by kind
        self.aux: dict[str, list[dict]] = {}
        self.persist_path = persist_path
        if persist_path and os.path.exists(persist_path):
            # bulk restore: group rows per pool, one upload per pool
            tasks: dict[tuple[str, str], list[TaskRecord]] = {}
            logs: dict[tuple[str, str], list[dict]] = {}
            for kind, payload in self._read_jsonl(persist_path):
                if kind == "task":
                    self.records.append(payload)
                    tasks.setdefault((payload.task_type, payload.machine),
                                     []).append(payload)
                elif kind == "log":
                    logs.setdefault((payload["task_type"],
                                     payload["machine"]), []).append(payload)
                else:
                    self.aux.setdefault(kind, []).append(payload)
            for key, recs in tasks.items():
                # ys stay float64 here: max_seen_gb is taken over the
                # full-precision values, as on the online path
                self.pool(*key).bulk_load(
                    np.asarray([r.features for r in recs], np.float32),
                    np.asarray([r.peak_mem_gb for r in recs]),
                    np.asarray([r.runtime_h for r in recs], np.float32))
            for key, rows in logs.items():
                self.pool(*key).bulk_load_log(
                    np.asarray([r["model_preds"] for r in rows],
                               np.float32).T,
                    np.asarray([r["agg"] for r in rows], np.float32),
                    np.asarray([r["actual"] for r in rows], np.float32),
                    np.asarray([r["runtime_h"] for r in rows], np.float32))

    def _read_jsonl(self, path: str) -> Iterator[tuple[str, object]]:
        lines, truncated = read_jsonl_lines(path)
        if truncated:
            warnings.warn(f"{path}: dropped a torn final checkpoint line "
                          f"(crash mid-append); restoring from the intact "
                          f"prefix", RuntimeWarning, stacklevel=2)
        for line in lines:
            d = json.loads(line)
            kind = d.pop("kind", None)
            if kind is None or kind == "task":
                d["features"] = tuple(d["features"])
                yield "task", TaskRecord(**d)
            elif kind == "log":
                yield "log", d
            else:
                yield kind, d

    def pool(self, task_type: str, machine: str) -> _PoolBuffers:
        key = (task_type, machine)
        if key not in self.pools:
            self.pools[key] = _PoolBuffers(self.n_features, self.n_models,
                                           self.device)
        return self.pools[key]

    def add(self, rec: TaskRecord) -> None:
        self.records.append(rec)
        self.pool(rec.task_type, rec.machine).add(
            rec.features, rec.peak_mem_gb, rec.runtime_h)
        if self.persist_path:
            with open(self.persist_path, "a") as f:
                f.write(rec.to_json() + "\n")

    def add_log(self, task_type: str, machine: str, model_preds, agg: float,
                actual: float, runtime_h: float) -> None:
        """Append one prequential-log row (and persist it, if configured)."""
        self.pool(task_type, machine).add_log(model_preds, agg, actual,
                                              runtime_h)
        if self.persist_path:
            row = {"kind": "log", "task_type": task_type, "machine": machine,
                   "model_preds": [float(p) for p in np.asarray(model_preds)],
                   "agg": float(agg), "actual": float(actual),
                   "runtime_h": float(runtime_h)}
            with open(self.persist_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def add_aux(self, kind: str, payload: dict) -> None:
        """Append one subsystem-owned checkpoint row (``kind`` must not be
        ``"log"``/``"task"``), kept in ``self.aux[kind]`` and persisted
        beside the core rows."""
        if kind in ("log", "task"):
            raise ValueError(f"aux kind {kind!r} collides with core rows")
        self.aux.setdefault(kind, []).append(payload)
        if self.persist_path:
            with open(self.persist_path, "a") as f:
                f.write(json.dumps({"kind": kind, **payload}) + "\n")
