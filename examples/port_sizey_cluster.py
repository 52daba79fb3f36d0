"""Sizey sizing LM jobs on a fleet of cards, on the PyTorch/CUDA port
(``examples/sizey_cluster.py`` over ``repro_torch``).

Ground truth comes from the port's dry run
(``python -m repro_torch.launch.dryrun``, rows in
``results/dryrun_torch.jsonl``): each (arch x shape x mesh) cell is a
"task type" whose peak memory per card Sizey learns online from cheap job
features (parameter GB per card, tokens per card, context length). Jobs
stream in repeatedly with jittered peaks; Sizey's allocation replaces the
static policy of reserving the whole cap, and OOM-kills follow the
paper's retry ladder. The cap is twice the largest peak in the rows.

    PYTHONPATH=src python examples/port_sizey_cluster.py              # card
    PYTHONPATH=src python examples/port_sizey_cluster.py --device cpu
    PYTHONPATH=src python examples/port_sizey_cluster.py \\
        --dryrun results/dryrun_train_seq_shard.jsonl --device cpu
"""
import argparse
import json
import os

import numpy as np

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import SizeyConfig
from repro_torch.launch.sizing import SizeyJobSizer
from repro_torch.utils.misc import resolve_device

DRYRUN = os.environ.get("REPRO_DRYRUN_RESULTS", "results/dryrun_torch.jsonl")


def load_cells():
    cells = []
    for line in open(DRYRUN):
        r = json.loads(line)
        if r.get("status") == "ok":
            cells.append((r["arch"], r["shape"], r["mesh"],
                          r["memory"]["peak_gb"]))
    return cells


def main():
    global DRYRUN
    ap = argparse.ArgumentParser(
        description="Sizey sizing LM jobs from dry-run memory analysis, on "
                    "the port")
    ap.add_argument("--dryrun", default=DRYRUN,
                    help="dry-run results JSONL (default: "
                         "$REPRO_DRYRUN_RESULTS or "
                         "results/dryrun_torch.jsonl)")
    ap.add_argument("--device", default=None,
                    help="torch device for Sizey (default: cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    DRYRUN = args.dryrun
    cells = load_cells()
    if not cells:
        raise SystemExit(f"no dry-run rows in {DRYRUN}; run "
                         "python -m repro_torch.launch.dryrun first")
    hbm_cap = max(p for *_, p in cells) * 2  # fleet nodes sized for worst
    preset = hbm_cap                          # static policy: reserve cap
    sizer = SizeyJobSizer(SizeyConfig(min_history=2), hbm_cap_gb=hbm_cap,
                          preset_gb=preset, device=dev)
    rng = np.random.default_rng(0)

    waste_sizey = waste_preset = 0.0
    ooms = 0
    n_jobs = 600
    for i in range(n_jobs):
        arch, shape_name, mesh, true_peak = cells[rng.integers(len(cells))]
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        chips = 256 if mesh == "single" else 512
        # jobs vary run to run (input jitter ~ the paper's input-size spread)
        peak = float(true_peak * rng.uniform(0.9, 1.1))
        runtime_h = float(rng.uniform(0.2, 2.0))

        job = sizer.size_job(arch, cfg, shape, mesh, chips)
        alloc = job.sizing.allocation_gb
        attempts = 1
        while alloc < peak:          # OOM-kill -> paper ladder
            waste_sizey += alloc * runtime_h * 0.1  # fails fast (ttf=0.1)
            ooms += 1
            alloc = sizer.retry_allocation(job, attempts, alloc)
            attempts += 1
        waste_sizey += (alloc - peak) * runtime_h
        waste_preset += (preset - peak) * runtime_h
        sizer.observe_job(job, peak, runtime_h, attempts)

    print(f"jobs: {n_jobs}  (cells: {len(cells)}, cap {hbm_cap:.0f} GB/chip)")
    print(f"static-preset wastage: {waste_preset:10.1f} GBh/chip")
    print(f"sizey wastage:         {waste_sizey:10.1f} GBh/chip "
          f"({ooms} OOM retries)")
    print(f"reduction: {100 * (1 - waste_sizey / waste_preset):.1f}%")


if __name__ == "__main__":
    main()
