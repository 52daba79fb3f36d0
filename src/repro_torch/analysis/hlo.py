"""Parse collective traffic out of optimized HLO text.

A copy of the reference's parser (``repro/analysis/hlo.py``): regular
expressions over text, framework-free, so on the same HLO text it returns
what the reference returns. Nothing in torch produces HLO; the port's dry
run counts its collectives as they are dispatched
(``analysis.collectives``), into the same dict.

We sum the result shapes of every all-gather / all-reduce / reduce-scatter
/ all-to-all / collective-permute op in the text. Async pairs are counted
once (the ``-start`` op carries the shape; ``-done`` is skipped), and
fusion-internal instructions are not collectives so no double counting.
"""
from __future__ import annotations

import re

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# `%name = TYPE op-name(...)` where TYPE is a shape or tuple of shapes
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+"
    r"((?:all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?)\(",
    re.M)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-kind and total collective bytes (result-shape accounting)."""
    out = {k: 0 for k in COLLECTIVE_KINDS}
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for type_str, opname in _OP_RE.findall(hlo_text):
        kind = opname.removesuffix("-start")
        out[kind] += _shape_bytes(type_str)
        counts[kind] += 1
    return {"bytes_by_kind": out, "counts": counts,
            "total_bytes": sum(out.values())}
