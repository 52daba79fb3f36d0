#!/usr/bin/env python3
"""Two dry runs' rows side by side, per cell: peak GiB, FLOPs and
collective bytes a card, and the roofline's bottleneck.

    python3 tools/port_dry_compare.py BEFORE.jsonl AFTER.jsonl \
        [--kind prefill,decode] [--markdown]

Each file holds ``python -m repro_torch.launch.dryrun --out`` rows (one
commit's, or one set of flags'). Cells are matched by (arch, shape,
mesh); a cell that is not ``ok`` in a file shows its status. Reads JSON
only: no torch, no card.
"""
from __future__ import annotations

import argparse
import json


def load(path: str) -> dict:
    rows = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            rows[(r["arch"], r["shape"], r["mesh"])] = r
    return rows


def cell(r) -> dict | None:
    if r is None or r.get("status") != "ok":
        return None
    return {"peak": r["memory"]["peak_gb"], "flops": r["cost"]["flops"],
            "coll": r["cost"]["collective_bytes"],
            "bound": r["roofline"]["bottleneck"], "kind": r["kind"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--kind", default="prefill,decode")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    kinds = set(args.kind.split(","))
    before, after = load(args.before), load(args.after)
    keys = sorted(set(before) | set(after),
                  key=lambda k: (k[2], k[1], k[0]))
    if args.markdown:
        print("| Cell, a card | peak GiB | FLOP | collective B | "
              "bottleneck |")
        print("| --- | --- | --- | --- | --- |")
    for key in keys:
        b, a = cell(before.get(key)), cell(after.get(key))
        if (a or b) is None or (a or b)["kind"] not in kinds:
            continue

        def pair(name, fmt):
            got = [fmt(c[name]) if c else "-" for c in (b, a)]
            return f"{got[0]} -> {got[1]}"
        name = f"{key[0]} {key[1]} ({key[2]})"
        cols = (pair("peak", lambda v: f"{v:,.2f}"),
                pair("flops", lambda v: f"{v:.3e}"),
                pair("coll", lambda v: f"{v:.3e}"),
                pair("bound", str))
        if args.markdown:
            print(f"| {name} | " + " | ".join(cols) + " |")
        else:
            print(f"{name:45s} " + "  ".join(cols))


if __name__ == "__main__":
    main()
