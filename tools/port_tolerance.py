"""Measure the spread that sets the port's end-to-end tolerance.

The MLP of Sizey's pool trains 3 learning rates x 300 full-batch Adam
steps on every observe, and Adam turns rounding differences into visible
weight differences; on small pools the learning-rate choice itself can
flip on rounding noise. The port cannot match the reference bit for bit
there, so its tolerance is the reference's own spread: this script
replays a workflow through the JAX package as it is, then again with the
MLP's initial weights moved by one ulp (W1 up, W1 down, W2 up, W2 down),
and prints the largest relative change of any allocation and of the
total wastage, and whether any integer choice (offset index, best model,
failure count) moved. It prints the reference's own wastage and failure
count first, and the range the perturbed replays span last. With
``--port`` it also replays the port (``repro_torch``) on the CPU and
prints the same comparison of the port against the unperturbed reference.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/port_tolerance.py \
        [--workflow methylseq] [--scale 0.05] [--port]

The figures it printed on a CPU are quoted beside the assertions of
tests/test_torch_slice.py (scale 0.05) and chip_smoke.py (scales 0.05
and 1.0).
"""
from __future__ import annotations

import argparse

import numpy as np


def replay(workflow: str, scale: float, port: bool = False):
    if port:
        import torch

        from repro_torch.baselines import SizeyMethod
        from repro_torch.workflow import generate_workflow, simulate
        torch.set_num_threads(1)   # thousands of tiny ops: one thread wins
        method = SizeyMethod(device="cpu")
    else:
        from repro.baselines import SizeyMethod
        from repro.workflow import generate_workflow, simulate
        method = SizeyMethod()
    decisions = []
    predict = method.predictor.predict

    def recording(*a, **k):
        d = predict(*a, **k)
        decisions.append(d)
        return d

    method.predictor.predict = recording
    res = simulate(generate_workflow(workflow, scale=scale), method)
    return res, decisions


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workflow", default="methylseq")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--port", action="store_true",
                    help="also replay the port on the CPU against the "
                         "reference")
    args = ap.parse_args()

    import jax.numpy as jnp

    import repro.core.models.mlp as mlp
    import repro.core.predictor as predictor

    base, d0 = replay(args.workflow, args.scale)
    print(f"reference {args.workflow} scale={args.scale}: "
          f"{len(base.outcomes)} tasks, wastage_gbh={base.wastage_gbh!r}, "
          f"n_failures={base.n_failures}")
    init = mlp._init_params
    worst_alloc = worst_waste = 0.0
    wastes, fails = [base.wastage_gbh], [base.n_failures]
    for which in ("w1", "w2"):
        for direction in (jnp.inf, -jnp.inf):
            def bumped(key, d, h, which=which, direction=direction):
                w1, b1, w2, b2 = init(key, d, h)
                if which == "w1":
                    w1 = jnp.nextafter(w1, direction)
                else:
                    w2 = jnp.nextafter(w2, direction)
                return w1, b1, w2, b2

            mlp._init_params = bumped
            for fn in (predictor._fused_observe_all,
                       predictor._fused_predict,
                       predictor._fused_refresh_all):
                fn.cache_clear()
            res, d1 = replay(args.workflow, args.scale)
            alloc, waste = compare(
                f"{which} {'+' if direction > 0 else '-'}1 ulp",
                base, d0, res, d1)
            worst_alloc = max(worst_alloc, alloc)
            worst_waste = max(worst_waste, waste)
            wastes.append(res.wastage_gbh)
            fails.append(res.n_failures)
    mlp._init_params = init
    print(f"spread: allocation rel {worst_alloc:.3e}, "
          f"wastage rel {worst_waste:.3e}; wastage_gbh "
          f"{min(wastes)!r}..{max(wastes)!r}, n_failures "
          f"{min(fails)}..{max(fails)}")
    if args.port:
        res, d1 = replay(args.workflow, args.scale, port=True)
        compare("port on the CPU", base, d0, res, d1)


def compare(label: str, base, d0, res, d1):
    """Print how far a replay moved from the unperturbed reference."""
    if len(d0) != len(d1):
        # a moved failure changes the retries, and with them the decisions
        print(f"{label}: {len(d1)} decisions against {len(d0)}; compared "
              f"pairwise up to the shorter")
    alloc = max(abs(a.allocation_gb - b.allocation_gb) / a.allocation_gb
                for a, b in zip(d0, d1) if a.source == "model")
    waste = abs(base.wastage_gbh - res.wastage_gbh) / base.wastage_gbh
    ints = sum(a.offset_idx != b.offset_idx
               or np.argmax(a.raq) != np.argmax(b.raq)
               for a, b in zip(d0, d1) if a.source == "model")
    print(f"{label}: max alloc rel {alloc:.3e}, wastage rel {waste:.3e} "
          f"(wastage_gbh {res.wastage_gbh!r}), integer choices moved "
          f"{ints}, failures {base.n_failures} -> {res.n_failures}")
    return alloc, waste


if __name__ == "__main__":
    main()
