"""Render the prediction-quality telemetry of one or more runs, on the
PyTorch/CUDA port (``examples/quality_report.py`` over ``repro_torch``).

    PYTHONPATH=src python examples/port_quality_report.py journal.jsonl \
        --out results/quality
    PYTHONPATH=src python examples/port_quality_report.py quality.csv \
        --out results/quality --device cpu

Input is either a provenance/journal JSONL (the ``kind="quality"`` aux
rows a ``SizeyMethod(quality=True)`` run emits) or the combined CSV that
``examples/port_workflow_sim.py --quality-out`` (or the reference's
``examples/workflow_sim.py``) writes. Output is
``OUT.csv`` — the canonical per-sample series — plus a per-pool summary
table on stdout and ``OUT.png`` when matplotlib is importable (the plot
is an optional artifact; the CSV carries everything either way).

The PNG shows, per pool, the prequential relative error of every
first-attempt allocation over the sample sequence (under-predictions
below zero — each one is an OOM retry), and the RAQ score of the
selected model as the ensemble adapts online — the operator's view of
the Sizey loop the paper can only describe in aggregate.

The report is host code over ``repro_torch.obs.quality``; it takes
``--device`` as every entry point of the port does (CUDA by default,
raising without a GPU rather than falling back) and puts nothing on it.
"""
import argparse
import csv
import os

from repro_torch.obs.quality import (read_quality_rows, summarize_pools,
                                     write_quality_csv)
from repro_torch.utils.misc import resolve_device

_NUMERIC = {"seq": int, "t_h": float, "raq": float, "offset_gb": float,
            "agg_pred_gb": float, "alloc_gb": float, "peak_gb": float,
            "under": int, "err_gb": float, "err_frac": float,
            "n_obs": int, "fit_serial": int, "next_fit_at": int}


def load_rows(path: str) -> list[dict]:
    if not path.endswith(".csv"):
        return read_quality_rows(path)
    rows = []
    with open(path, newline="") as fh:
        for rec in csv.DictReader(fh):
            row = dict(rec)
            for key, cast in _NUMERIC.items():
                val = row.get(key)
                row[key] = cast(float(val)) if val not in (None, "") else None
            rows.append(row)
    return rows


def _pool_key(row: dict) -> str:
    key = row.get("task_type", "?")
    if row.get("machine"):
        key = f"{key}@{row['machine']}"
    return key


def print_summary(rows: list[dict]) -> None:
    summary = summarize_pools(rows)
    hdr = (f"{'pool':24} {'n':>6} {'under%':>7} {'|err|%':>7} "
           f"{'over%':>7} {'raq':>6} {'fits':>5}  model")
    print(hdr)
    print("-" * len(hdr))
    for pool, s in summary.items():
        raq = f"{s['last_raq']:.3f}" if s["last_raq"] is not None else "-"
        print(f"{pool:24} {s['n']:>6} {100 * s['under_frac']:>6.1f}% "
              f"{100 * s['mean_abs_err_frac']:>6.1f}% "
              f"{100 * s['mean_over_frac']:>6.1f}% {raq:>6} "
              f"{s['n_fits']:>5}  {s['last_model'] or '-'}")


def write_png(rows: list[dict], path: str, max_pools: int = 8) -> bool:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    pools: dict[str, list[dict]] = {}
    for row in rows:
        pools.setdefault(_pool_key(row), []).append(row)
    # largest pools carry the signal; a legend of 40 pools carries none
    top = sorted(pools, key=lambda p: -len(pools[p]))[:max_pools]
    fig, (ax0, ax1) = plt.subplots(2, 1, sharex=True, figsize=(9, 7))
    for pool in top:
        rs = pools[pool]
        xs = [r["seq"] for r in rs]
        ax0.plot(xs, [r["err_frac"] for r in rs], ".", ms=3, label=pool)
        raq_pts = [(r["seq"], r["raq"]) for r in rs
                   if r.get("raq") is not None]
        if raq_pts:
            ax1.plot(*zip(*raq_pts), "-", lw=1, label=pool)
    ax0.axhline(0.0, color="k", lw=0.5)
    ax0.set_ylabel("prequential relative error\n(first alloc vs peak)")
    ax0.legend(loc="upper right", fontsize=7)
    ax1.set_ylabel("RAQ of selected model")
    ax1.set_xlabel("completion sequence")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input", help="provenance/journal JSONL with quality "
                                  "aux rows, or a --quality-out CSV")
    ap.add_argument("--out", default="results/quality", metavar="BASE",
                    help="write BASE.csv (always) and BASE.png (when "
                         "matplotlib is importable)")
    ap.add_argument("--device", default=None,
                    help="torch device of the port's entry points "
                         "(default: cuda); the report itself runs on the "
                         "host")
    args = ap.parse_args()
    resolve_device(args.device)
    rows = load_rows(args.input)
    if not rows:
        raise SystemExit(f"{args.input}: no quality rows — run the method "
                         f"with quality=True (e.g. port_workflow_sim.py "
                         f"--quality-out)")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_quality_csv(rows, args.out + ".csv")
    print(f"wrote {args.out}.csv ({len(rows)} samples, "
          f"{len({_pool_key(r) for r in rows})} pools)\n")
    print_summary(rows)
    if write_png(rows, args.out + ".png"):
        print(f"\nwrote {args.out}.png")
    else:
        print("\nmatplotlib unavailable; skipping the PNG")


if __name__ == "__main__":
    main()
