"""Event journal (write-ahead log) for the durable cluster engine: a copy
of the reference's numpy-only ``repro.workflow.journal``, with its imports
pointed at the port and the reference's row layout, key for key.

The journal makes a :class:`~repro_torch.workflow.cluster.ClusterEngine` run
*crash-recoverable*: every engine step appends one WAL row recording the
method interactions that seeds cannot re-derive (sizing-wave allocations
with their in-flight decision blobs, OOM retry allocations, completion
keys, the method's counter state), and every ``snapshot_every`` steps a
compacted full-state snapshot row is written. Rows live as *aux rows* in
the same provenance JSONL the predictor checkpoints to
(:meth:`~repro_torch.core.provenance.ProvenanceDB.add_aux`), so one file holds
the full durable state of a run: model history + engine WAL.

File layout of a journaled run (one append-only JSONL)::

    {"kind": "wal",  "rec": "begin", "config": ..., "trace_fp": ...,
                     "method_name": ..., "resumed_from": null}
    {"kind": "task", ...}   {"kind": "log", ...}   {"kind": "curve", ...}
    {"kind": "wal",  "rec": "step", "step": 0, "ev": [...],
                     "sized": [[key, alloc, blob], ...], "refresh": [...],
                     "retries": [[key, alloc], ...], "done": [key, ...],
                     "clock": ..., "mstate": {...}}
    ...
    {"kind": "snap", "step": 64, "state": {...}}
    ...
    {"kind": "wal",  "rec": "end", "step": N, "n_outcomes": M}

Write ordering is the recovery invariant: within one step the provenance
rows (task / log / curve) of that step's completions are appended DURING
the event drain and the step's WAL row at the END of the step. A crash
therefore leaves at most one *partially executed* step on disk — its
provenance rows with no closing WAL row. :meth:`Journal.repair` truncates
exactly those orphan rows (plus any torn final line), restoring the file
to the last step boundary; the predictor then warm-starts from a
journal-consistent prefix and live re-execution of the lost step is
bit-for-bit the uninterrupted step. This is why kill-at-ANY-byte + resume
reproduces the uninterrupted ``SimResult`` exactly (asserted across kill
points in ``tests/test_durability.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable

from repro_torch.core.provenance import (ProvenanceDB,
                                         atomic_rewrite_jsonl,
                                         read_jsonl_lines)
from repro_torch.obs.trace import span as _span

__all__ = ["WAL_KIND", "SNAP_KIND", "Journal", "JournaledRun",
           "recover_run"]

WAL_KIND = "wal"     # step records + run begin/end markers
SNAP_KIND = "snap"   # compacted full-state engine snapshots


@dataclasses.dataclass
class JournaledRun:
    """What :meth:`Journal.load` reconstructs from the backing file."""
    config: dict                 # engine kwargs of the journaled run
    trace_fp: int                # fingerprint of the trace it executed
    method_name: str
    snapshot: dict | None        # last engine snapshot state (or None)
    tail: list[dict]             # step records from the snapshot onward
    complete: bool               # run reached its "end" marker
    mstate: dict | None          # method counters at the last journaled step
    resumed_from: int | None     # step of the last recovery (None: gen 0)


class Journal:
    """WAL + snapshot writer/reader over a :class:`ProvenanceDB`.

    The journal does not open files itself — it rides the db's
    ``persist_path`` appends, so WAL rows interleave with the predictor's
    own checkpoint rows in exactly execution order (the property
    :meth:`repair` relies on).
    """

    def __init__(self, db: ProvenanceDB, *, snapshot_every: int = 64):
        if db.persist_path is None:
            raise ValueError("journaling needs a persistent ProvenanceDB "
                             "(persist_path=None given)")
        if snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, "
                             f"got {snapshot_every}")
        self.db = db
        self.snapshot_every = snapshot_every

    @classmethod
    def attach(cls, method, *, snapshot_every: int = 64) -> "Journal":
        """Journal onto the provenance db ``method`` already persists to
        (the usual construction: one file per durable run)."""
        predictor = getattr(method, "predictor", None)
        db = getattr(predictor, "db", None) or getattr(method, "db", None)
        if db is None:
            raise ValueError(f"method {getattr(method, 'name', method)!r} "
                             f"exposes no provenance db to journal onto")
        return cls(db, snapshot_every=snapshot_every)

    @property
    def path(self) -> str:
        """The backing JSONL file (the db's ``persist_path``)."""
        return self.db.persist_path

    # -------------------------------------------------------------- writes
    def begin(self, *, config: dict, trace_fp: int, method_name: str,
              resumed_from: int | None = None) -> None:
        """Write the run's ``begin`` marker (engine config, trace
        fingerprint, method name). ``resumed_from`` stamps recovery
        generations so history never replays twice."""
        self.db.add_aux(WAL_KIND, {
            "rec": "begin", "config": config, "trace_fp": trace_fp,
            "method_name": method_name, "resumed_from": resumed_from})

    def append_step(self, rec: dict) -> None:
        """Append one step's WAL row — everything seeds cannot re-derive
        (drained events, wave allocations + decision blobs, retries,
        completions, clock, method counters). MUST be written at the END
        of the step, after the step's provenance rows: that ordering is
        what lets :meth:`repair` truncate a crash back to the last step
        boundary."""
        self.db.add_aux(WAL_KIND, rec)

    def end(self, *, step: int, n_outcomes: int) -> None:
        """Write the ``end`` marker; a journal without one is an
        unfinished run that :func:`recover_run` may resume."""
        self.db.add_aux(WAL_KIND, {"rec": "end", "step": step,
                                   "n_outcomes": n_outcomes})

    def snapshot(self, state: dict) -> None:
        """Write a compacted full-state engine snapshot row (everything
        ``ClusterEngine.export_state()`` serializes — indexes excluded:
        they rebuild deterministically on restore)."""
        with _span("journal/snapshot", step=state["step"]):
            self.db.add_aux(SNAP_KIND,
                            {"step": state["step"], "state": state})

    def maybe_snapshot(self, step_idx: int,
                       state_fn: Callable[[], dict]) -> None:
        """Snapshot on the cadence (called after every completed step)."""
        if step_idx % self.snapshot_every == 0:
            self.snapshot(state_fn())

    # --------------------------------------------------------------- reads
    def load(self) -> JournaledRun | None:
        """Reconstruct the journaled run from the db's restored aux rows
        (None when the file holds no WAL). Uses the LAST ``begin`` marker
        — a recovered run re-begins, and its immediate post-recovery
        snapshot supersedes all older generations."""
        rows = self.db.aux.get(WAL_KIND, [])
        if not rows:
            return None
        meta = None
        for r in rows:
            if r.get("rec") == "begin":
                meta = r
        if meta is None:
            raise ValueError(f"{self.path}: WAL rows without a begin "
                             f"marker — not a journaled run")
        steps: dict[int, dict] = {}
        for r in rows:
            if r.get("rec") == "step":
                steps[int(r["step"])] = r   # duplicates: last write wins
        snaps = self.db.aux.get(SNAP_KIND, [])
        snapshot = snaps[-1]["state"] if snaps else None
        base = int(snapshot["step"]) if snapshot is not None else 0
        tail = [steps[i] for i in sorted(steps) if i >= base]
        for off, r in enumerate(tail):
            if int(r["step"]) != base + off:
                raise ValueError(
                    f"{self.path}: journal gap — expected step "
                    f"{base + off}, found {r['step']} (corrupt or "
                    f"mixed-run file)")
        mstate = None
        if snapshot is not None:
            mstate = snapshot.get("mstate")
        for r in tail:
            if r.get("mstate") is not None:
                mstate = r["mstate"]
        return JournaledRun(
            config=meta["config"], trace_fp=meta["trace_fp"],
            method_name=meta["method_name"], snapshot=snapshot, tail=tail,
            complete=(rows[-1].get("rec") == "end"), mstate=mstate,
            resumed_from=meta.get("resumed_from"))

    # -------------------------------------------------------------- repair
    @staticmethod
    def repair(path: str) -> dict:
        """Restore a crashed journal file to its last step boundary.

        Drops (a) a torn final line (the crash interrupted an append
        mid-write) and (b) every provenance row AFTER the last intact
        journal row — orphans of the partially executed step, whose
        completions the recovered engine will re-execute live (re-writing
        equivalent rows). A file whose last journal row is the ``end``
        marker is complete and left untouched. Run this BEFORE
        constructing the method, so the predictor warm-starts from the
        journal-consistent prefix.

        Returns ``{"repaired": bool, "dropped_rows": int,
        "torn_final_line": bool}``.
        """
        stats = {"repaired": False, "dropped_rows": 0,
                 "torn_final_line": False}
        if not os.path.exists(path):
            return stats
        with _span("journal/repair", path=os.path.basename(path)):
            return Journal._repair_inner(path, stats)

    @staticmethod
    def _repair_inner(path: str, stats: dict) -> dict:
        lines, torn = read_jsonl_lines(path)
        stats["torn_final_line"] = torn
        last_j = None          # index of the last journal (wal/snap) row
        last_rec = None
        for i, line in enumerate(lines):
            kind = json.loads(line).get("kind")
            if kind in (WAL_KIND, SNAP_KIND):
                last_j = i
                if kind == WAL_KIND:
                    last_rec = json.loads(line).get("rec")
        keep = lines
        if last_j is not None and last_rec != "end" \
                and last_j + 1 < len(lines):
            keep = lines[:last_j + 1]
            stats["dropped_rows"] = len(lines) - len(keep)
        if torn or keep is not lines:
            atomic_rewrite_jsonl(path, keep)
            stats["repaired"] = True
        return stats


def recover_run(path: str, trace, method_factory, *, resume: str = "warm",
                snapshot_every: int = 64):
    """One-call crash recovery: repair the journal file at ``path``, build
    the method from the repaired file (``method_factory(path)`` — the
    predictor warm-starts from the journal-consistent prefix), and return
    the recovered :class:`~repro_torch.workflow.cluster.ClusterEngine` ready to
    continue (``resume='warm'``) or to re-dispatch in-flight attempts
    through the failure strategy (``resume='cold'``)."""
    from repro_torch.workflow.cluster import ClusterEngine
    Journal.repair(path)
    method = method_factory(path)
    journal = Journal.attach(method, snapshot_every=snapshot_every)
    return ClusterEngine.recover(trace, method, journal, resume=resume)
