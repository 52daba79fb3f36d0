"""Risk-pricing telemetry: one aux row per risk-priced sizing decision.

:class:`~repro_torch.baselines.sizey_method.SizeyMethod` (with ``risk=...``)
emits a ``kind="risk"`` aux row on the provenance stream for every
decision the risk layer actually repriced — the chosen reservation
quantile and the band width ride the same JSONL/journal as the rest of
provenance. Cold pools and preset decisions emit nothing (they run the
paper path bitwise), so the row count is also the repriced-decision
count.

Durability: rows are emitted inside ``allocate``/``allocate_batch``,
which journal replay never calls (replayed waves re-apply journaled
allocations verbatim) — replayed steps' rows already sit in the
warm-start prefix, and a repair-dropped step re-executes live from
bit-identical restored state, regenerating its rows bitwise
(``tests/test_torch_risk.py`` pins this across kill points).

Row schema (``RISK_FIELDS`` order)::

    seq             global sample index (emission order)
    t_h             virtual-clock hours at the last completion wave
    task_type       pool key
    machine         pool machine ("" for single-machine traces)
    tau             priced reservation quantile
    band_gb         calibrated band width (conformal + spread term)
    pressure        cluster pressure sample the price used
    crash_p         crashes-per-attempt probability the price used
    agg_pred_gb     raw RAQ-weighted aggregate prediction
    offset_alloc_gb what the paper's offset path would have allocated
    alloc_gb        the risk-priced allocation actually requested
    collapsed       1 if a temporal plan was flattened (per-pool k=1)

Stdlib only — reads either a provenance JSONL path or a live
``ProvenanceDB``-shaped object (anything with an ``aux`` dict).
"""
from __future__ import annotations

import json
import os

__all__ = ["RISK_KIND", "RISK_FIELDS", "read_risk_rows", "summarize_risk"]

RISK_KIND = "risk"

RISK_FIELDS = ("seq", "t_h", "task_type", "machine", "tau", "band_gb",
               "pressure", "crash_p", "agg_pred_gb", "offset_alloc_gb",
               "alloc_gb", "collapsed")


def read_risk_rows(source) -> list[dict]:
    """Load risk rows from a provenance JSONL path or a live db, in
    emission (``seq``) order."""
    if isinstance(source, (str, os.PathLike)):
        rows = []
        with open(source) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("kind") == RISK_KIND:
                    rec.pop("kind", None)
                    rows.append(rec)
    else:
        rows = [dict(r) for r in source.aux.get(RISK_KIND, [])]
    rows.sort(key=lambda r: r.get("seq", 0))
    return rows


def summarize_risk(rows: list[dict]) -> dict:
    """Digest of a run's pricing behavior: row count, quantile range,
    mean band width, how often the risk price undercut / exceeded the
    paper offset, and the temporal collapse count."""
    if not rows:
        return {"n": 0}
    taus = [r["tau"] for r in rows]
    bands = [r["band_gb"] for r in rows]
    tighter = sum(1 for r in rows
                  if r["alloc_gb"] < r["offset_alloc_gb"])
    wider = sum(1 for r in rows
                if r["alloc_gb"] > r["offset_alloc_gb"])
    return {
        "n": len(rows),
        "tau_min": min(taus), "tau_max": max(taus),
        "mean_band_gb": sum(bands) / len(bands),
        "tighter_than_offset": tighter,
        "wider_than_offset": wider,
        "n_collapsed": sum(1 for r in rows if r.get("collapsed")),
    }
