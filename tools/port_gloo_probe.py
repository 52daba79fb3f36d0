#!/usr/bin/env python3
"""Which functional collectives of CUDA tensors the installed torch's gloo
carries: two gloo ranks on one card, each collective in a pair of fresh
processes (a crash ends only its pair).

    python3 tools/port_gloo_probe.py

Prints each collective's exit codes: [0, 0] where both ranks got the
expected values, -11 where a rank died of SIGSEGV. Needs a card; the
rendezvous is a file in a temporary directory (no port).
"""
from __future__ import annotations

import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

COLLECTIVES = ("reduce_scatter", "all_to_all", "all_gather")


def rank_main(rank: int, store: str, what: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    name = dist.group.WORLD.group_name
    c = torch.ops._c10d_functional
    x = torch.full((4, 8, 16), float(rank + 1), device="cuda")
    ones = torch.ones(4, 8, 16)
    if what == "all_gather":
        y = c.wait_tensor(c.all_gather_into_tensor(x, 2, name)).cpu()
        assert torch.equal(y[:4], ones) and torch.equal(y[4:], 2 * ones)
    elif what == "all_to_all":
        y = c.wait_tensor(c.all_to_all_single(torch.cat([x, x]), [4, 4],
                                              [4, 4], name)).cpu()
        assert torch.equal(y[:4], ones) and torch.equal(y[4:], 2 * ones)
    else:
        y = c.wait_tensor(c.reduce_scatter_tensor(torch.cat([x, x]), "sum",
                                                  2, name)).cpu()
        assert torch.equal(y, 3 * ones)
    torch.cuda.synchronize()
    dist.destroy_process_group()


def main() -> None:
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    for what in COLLECTIVES:
        with tempfile.TemporaryDirectory() as d:
            procs = [subprocess.Popen([sys.executable, __file__, str(r),
                                       f"{d}/store", what])
                     for r in range(2)]
            rcs = []
            for p in procs:
                try:
                    rcs.append(p.wait(timeout=120))
                except subprocess.TimeoutExpired:
                    p.kill()
                    rcs.append("timeout")
        print(f"{what}: exit codes {rcs}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    else:
        main()
