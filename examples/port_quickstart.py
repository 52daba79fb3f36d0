"""Quickstart on the PyTorch/CUDA port: Sizey vs the baselines on one
workflow (``examples/quickstart.py`` over ``repro_torch``).

    PYTHONPATH=src python examples/port_quickstart.py               # the card
    PYTHONPATH=src python examples/port_quickstart.py --device cpu  # no GPU

Sizey runs on ``--device`` (CUDA by default; without a GPU, CUDA raises
rather than falling back); the numpy baselines run on the host.
"""
import argparse

from repro_torch.baselines import make_method
from repro_torch.baselines.sizey_method import SizeyMethod
from repro_torch.core import SizeyConfig
from repro_torch.utils.misc import resolve_device
from repro_torch.workflow import generate_workflow, simulate


def main():
    ap = argparse.ArgumentParser(
        description="Sizey vs the baselines on one workflow, on the port")
    ap.add_argument("--scale", type=float, default=0.2,
                    help="trace scale factor (default 0.2)")
    ap.add_argument("--device", default=None,
                    help="torch device for Sizey (default: cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    # mag has the most instances per task type (Table I: 720) — the
    # regime where online learning has room even at reduced scale
    trace = generate_workflow("mag", scale=args.scale)
    print(f"workflow: {trace.summary()}\n")
    print(f"{'method':18s} {'wastage GBh':>12s} {'failures':>9s} "
          f"{'runtime h':>10s}")
    rows = []
    for name in ["sizey", "witt_wastage", "witt_lr", "tovar_ppm",
                 "witt_percentile", "workflow_presets"]:
        method = (SizeyMethod(SizeyConfig(), ttf=1.0, device=dev)
                  if name == "sizey" else make_method(name))
        r = simulate(trace, method, ttf=1.0)
        rows.append((name, r))
        print(f"{name:18s} {r.wastage_gbh:12.2f} {r.n_failures:9d} "
              f"{r.total_runtime_h:10.2f}")

    sizey = rows[0][1].wastage_gbh
    best_baseline = min(r.wastage_gbh for n, r in rows[1:])
    print(f"\nSizey wastage reduction vs best baseline: "
          f"{100 * (1 - sizey / best_baseline):.1f}%  (paper: 24.68% median)")


if __name__ == "__main__":
    main()
