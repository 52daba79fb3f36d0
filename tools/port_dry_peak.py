#!/usr/bin/env python3
"""What a dry-run cell holds at its traced peak: the live storages of
rank 0 at the moment the peak was reached, grouped by the op that made
them, their shape and type, largest first.

    PYTHONPATH=src python3 tools/port_dry_peak.py --arch grok-1-314b \
        --shape train_4k [--mesh single|multi] [--seq-shard] [--top 20]

The cell is traced as ``python -m repro_torch.launch.dryrun`` traces it
(the production meshes over a fake process group, fake tensors on
``--device``, cuda by default), with ``TraceMode``'s books extended to
remember each storage's maker. Nothing is allocated or launched; run it
where the dry run's CUDA tracing runs (the card's machine).
"""
from __future__ import annotations

import argparse
import collections
import logging

import torch

from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun

GIB = 1024 ** 3


class PeakMode(dryrun.TraceMode):
    """``TraceMode`` that keeps, for each storage, the op, shape and type
    of the tensor that first held it, and the set of live storages at the
    latest peak."""

    def __init__(self):
        super().__init__()
        self.made = {}
        self.at_peak = frozenset()
        self._op = "argument"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        prev, self._op = self._op, func._opname
        try:
            return super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._op = prev

    def _hold(self, t) -> None:
        key = id(t.untyped_storage())
        if key not in self._held:
            self.made[key] = (self._op, tuple(t.shape), str(t.dtype),
                              t.untyped_storage().nbytes())
        before = self.peak
        super()._hold(t)
        if self.peak > before:
            self.at_peak = frozenset(self._held)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    world, make = dryrun.make_meshes(False, args.device)[args.mesh]
    modes = []

    class Recorded(PeakMode):
        def __init__(self):
            super().__init__()
            modes.append(self)
    dryrun.TraceMode = Recorded
    cfg = dryrun.cell_config(args.arch, seq_shard=args.seq_shard)
    with dryrun.fake_world(world):
        got = dryrun.trace_cell(cfg, SHAPES[args.shape], make(),
                                device=args.device)
    mode = modes[0]
    groups = collections.defaultdict(lambda: [0, 0])
    for key in mode.at_peak:
        op, shape, dtype, n = mode.made[key]
        groups[(op, shape, dtype)][0] += 1
        groups[(op, shape, dtype)][1] += n
    mem = got["memory"]
    total = sum(n for _, n in groups.values())
    print(f"{args.arch} {args.shape} on {world} ranks"
          f"{' with --seq-shard' if args.seq_shard else ''}: peak "
          f"{mem['peak_gb']:.2f} GiB a card (arguments "
          f"{mem['argument_gb']:.2f}); {len(mode.at_peak)} storages live "
          f"at the peak, {total / GIB:.2f} GiB")
    for (op, shape, dtype), (count, n) in sorted(
            groups.items(), key=lambda kv: -kv[1][1])[:args.top]:
        print(f"  {n / GIB:9.3f} GiB  {count:5d} x {op} {list(shape)} "
              f"{dtype.replace('torch.', '')}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
