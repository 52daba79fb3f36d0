"""Prediction-quality telemetry: per-pool time series of the online
sizing loop's health.

:class:`~repro_torch.baselines.sizey_method.SizeyMethod` (with
``quality=True``) emits one row per completed task as a
``kind="quality"`` aux row on the provenance stream, so the series rides
the same JSONL/journal as the rest of provenance and survives
``Journal.repair`` truncation and kill-at-any-byte warm resume bitwise
(every field is a pure function of journal-restorable predictor state).

Row schema (``QUALITY_FIELDS`` order)::

    seq         global sample index (emission order)
    t_h         virtual-clock hours at completion (0.0 in serial runs)
    task_type   pool key
    machine     temporal pool machine ("" for non-temporal)
    raq         RAQ score of the selected model (None pre-model)
    model       selected model name (None pre-model)
    offset_gb   dynamic offset applied (None pre-model)
    agg_pred_gb aggregate model prediction (None pre-model)
    source      decision source ("model" / "default" / ...)
    alloc_gb    first-attempt allocation
    peak_gb     observed actual peak
    under       1 if first attempt under-predicted, else 0
    err_gb      alloc_gb - peak_gb (signed; <0 = under)
    err_frac    err_gb / peak_gb  (prequential relative error)
    n_obs       pool observation count after this completion
    fit_serial  fit serial of the pool's current model (0 = none)
    next_fit_at pool count that triggers the next amortized refit

Stdlib only — reads either a provenance JSONL path or a live
``ProvenanceDB``-shaped object (anything with an ``aux`` dict).
"""
from __future__ import annotations

import csv
import json
import os

__all__ = ["QUALITY_KIND", "QUALITY_FIELDS", "read_quality_rows",
           "summarize_pools", "write_quality_csv"]

QUALITY_KIND = "quality"

QUALITY_FIELDS = ("seq", "t_h", "task_type", "machine", "raq", "model",
                  "offset_gb", "agg_pred_gb", "source", "alloc_gb",
                  "peak_gb", "under", "err_gb", "err_frac", "n_obs",
                  "fit_serial", "next_fit_at")


def read_quality_rows(source) -> list[dict]:
    """Load quality rows from a provenance JSONL path or a live db.

    Accepts a filesystem path (reads ``kind == "quality"`` lines) or any
    object with an ``aux`` mapping (e.g. ``ProvenanceDB``). Returns rows
    in emission (``seq``) order."""
    if isinstance(source, (str, os.PathLike)):
        rows = []
        with open(source) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("kind") == QUALITY_KIND:
                    rec.pop("kind", None)
                    rows.append(rec)
    else:
        rows = [dict(r) for r in source.aux.get(QUALITY_KIND, [])]
    rows.sort(key=lambda r: r.get("seq", 0))
    return rows


def write_quality_csv(rows: list[dict], path) -> None:
    """Write rows as CSV in canonical field order (CSV always works;
    plots are optional elsewhere)."""
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=QUALITY_FIELDS,
                                extrasaction="ignore")
        writer.writeheader()
        for row in rows:
            writer.writerow({k: row.get(k) for k in QUALITY_FIELDS})


def summarize_pools(rows: list[dict]) -> dict:
    """Per-pool digest keyed ``"task_type"`` or ``"task_type@machine"``.

    Reports sample count, under-prediction rate, mean absolute relative
    error, mean over-prediction fraction (wastage proxy), latest RAQ /
    model / offset, and the number of distinct model fits observed."""
    pools: dict[str, list[dict]] = {}
    for row in rows:
        key = row.get("task_type", "?")
        machine = row.get("machine") or ""
        if machine:
            key = f"{key}@{machine}"
        pools.setdefault(key, []).append(row)

    out = {}
    for key, rs in sorted(pools.items()):
        n = len(rs)
        unders = sum(1 for r in rs if r.get("under"))
        errs = [r["err_frac"] for r in rs if r.get("err_frac") is not None]
        overs = [e for e in errs if e > 0]
        last = rs[-1]
        out[key] = {
            "n": n,
            "under_frac": unders / n if n else 0.0,
            "mean_abs_err_frac": (sum(abs(e) for e in errs) / len(errs)
                                  if errs else 0.0),
            "mean_over_frac": sum(overs) / len(overs) if overs else 0.0,
            "last_raq": last.get("raq"),
            "last_model": last.get("model"),
            "last_offset_gb": last.get("offset_gb"),
            "n_fits": len({r.get("fit_serial") for r in rs
                           if r.get("fit_serial")}),
        }
    return out
