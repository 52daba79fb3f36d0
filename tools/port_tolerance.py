"""Measure the spread that sets the port's end-to-end tolerance.

The MLP of each Sizey pool trains 3 learning rates x 300 full-batch Adam
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

``--method sizey_temporal`` replays the temporal path instead (one
decision per segment; the comparison also counts decisions whose
boundaries moved) and prints, for the unperturbed reference, how many
boundary fits it ran and on how many of them its jitted fit
(``repro.kernels.segment_dp.ops.fit_cuts``) departs from its numpy oracle
(``ref.fit_cuts_ref``), which the port's kernel reproduces.

``--apart POOL`` reports the allocation spread of one pool (task type)
on its own and that of every other pool beside it, so that one pool
whose learning-rate choice flips on rounding noise sets a tolerance for
itself alone.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/port_tolerance.py \
        [--workflow methylseq] [--scale 0.05] [--method sizey] \
        [--apart POOL] [--port]

The figures it printed on a CPU are quoted beside the assertions of
tests/test_torch_slice.py and tests/test_torch_temporal.py (scale 0.05)
and chip_smoke.py (scales 0.05 and 1.0).
"""
from __future__ import annotations

import argparse
import functools

import numpy as np


def replay(workflow: str, scale: float, method_name: str = "sizey",
           port: bool = False):
    """One replay: its result, its decisions (one per segment on the
    temporal path) and each decision's boundaries."""
    if port:
        import torch

        from repro_torch.baselines import make_method
        from repro_torch.workflow import generate_workflow, simulate
        torch.set_num_threads(1)   # thousands of tiny ops: one thread wins
        method = make_method(method_name, device="cpu")
    else:
        from repro.baselines import make_method
        from repro.workflow import generate_workflow, simulate
        method = make_method(method_name)
    decisions, bounds = [], []
    if method_name == "sizey_temporal":
        predict_batch = method.predictor.predict_batch

        def recording(tasks):
            out = predict_batch(tasks)
            for d in out:
                decisions.extend(d.seg_decisions)
                bounds.extend([d.boundaries] * len(d.seg_decisions))
            return out

        method.predictor.predict_batch = recording
    else:
        predict = method.predictor.predict

        def recording(*a, **k):
            d = predict(*a, **k)
            decisions.append(d)
            bounds.append((1.0,))
            return d

        method.predictor.predict = recording
    res = simulate(generate_workflow(workflow, scale=scale), method)
    return res, decisions, bounds


def moved_init(init, sample: int, key, d, h):
    """The reference's MLP init with its weights moved by one ulp: sample
    0..3 move all of W1 up, W1 down, W2 up, W2 down; a later sample moves a
    random half of W1's and W2's elements (seeded by the sample), each up
    or down."""
    import jax
    import jax.numpy as jnp
    w1, b1, w2, b2 = init(key, d, h)
    if sample < 4:
        direction = jnp.inf if sample % 2 == 0 else -jnp.inf
        if sample < 2:
            return jnp.nextafter(w1, direction), b1, w2, b2
        return w1, b1, jnp.nextafter(w2, direction), b2
    keys = jax.random.split(jax.random.PRNGKey(1000 + sample), 4)

    def move(w, k_pick, k_dir):
        pick = jax.random.bernoulli(k_pick, 0.5, w.shape)
        up = jax.random.bernoulli(k_dir, 0.5, w.shape)
        return jnp.where(pick, jnp.nextafter(
            w, jnp.where(up, jnp.inf, -jnp.inf)), w)

    return move(w1, keys[0], keys[1]), b1, move(w2, keys[2], keys[3]), b2


def move_label(sample: int) -> str:
    if sample < 4:
        return f"{'w1' if sample < 2 else 'w2'} " \
               f"{'+' if sample % 2 == 0 else '-'}1 ulp"
    return f"random half +-1 ulp, sample {sample}"


def reference_fit_departures(workflow: str, scale: float):
    """Replay the reference's temporal path recording every boundary fit;
    return the number of fits and of those where its jitted fit departs
    from its numpy oracle."""
    import repro.core.temporal.predictor as tp
    from repro.kernels.segment_dp.ops import fit_cuts
    from repro.kernels.segment_dp.ref import fit_cuts_ref
    fits = []
    fit = tp.fit_boundaries

    def recording(P, k, **kw):
        fits.append((np.asarray(P, np.float32), int(min(k, P.shape[1]))))
        return fit(P, k, **kw)

    tp.fit_boundaries = recording
    try:
        replay(workflow, scale, "sizey_temporal")
    finally:
        tp.fit_boundaries = fit
    departs = sum(not np.array_equal(fit_cuts(P, k), fit_cuts_ref(P, k))
                  for P, k in fits)
    return len(fits), departs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workflow", default="methylseq")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--method", default="sizey",
                    choices=("sizey", "sizey_temporal"))
    ap.add_argument("--samples", type=int, default=4,
                    help="number of 1-ulp moves of the MLP init (the first "
                         "four move all of W1 or W2 up or down; the rest "
                         "move a seeded random half of their elements, "
                         "each up or down)")
    ap.add_argument("--apart", default=None, metavar="POOL",
                    help="report this task type's allocation spread apart "
                         "from that of the other pools")
    ap.add_argument("--port", action="store_true",
                    help="also replay the port on the CPU against the "
                         "reference")
    args = ap.parse_args()

    import jax.numpy as jnp

    import repro.core.models.mlp as mlp
    import repro.core.predictor as predictor

    base, d0, b0 = replay(args.workflow, args.scale, args.method)
    print(f"reference {args.method} {args.workflow} scale={args.scale}: "
          f"{len(base.outcomes)} tasks, wastage_gbh={base.wastage_gbh!r}, "
          f"temporal_wastage_gbh={base.temporal_wastage_gbh!r}, "
          f"n_failures={base.n_failures}")
    if args.method == "sizey_temporal":
        n, departs = reference_fit_departures(args.workflow, args.scale)
        print(f"reference boundary fits: {n}; its jitted fit departs from "
              f"its numpy oracle on {departs}")
    init = mlp._init_params
    worst_alloc = worst_apart = worst_waste = 0.0
    # the temporal path is judged on the time-integrated wastage
    metric = ("temporal_wastage_gbh" if args.method == "sizey_temporal"
              else "wastage_gbh")
    wastes, fails, moved = [getattr(base, metric)], [base.n_failures], []
    for sample in range(args.samples):
        mlp._init_params = functools.partial(moved_init, init, sample)
        for fn in (predictor._fused_observe_all,
                   predictor._fused_predict,
                   predictor._fused_refresh_all):
            fn.cache_clear()
        res, d1, b1 = replay(args.workflow, args.scale, args.method)
        alloc, apart, waste, ints = compare(move_label(sample), base, d0,
                                            b0, res, d1, b1, metric,
                                            args.apart)
        worst_alloc = max(worst_alloc, alloc)
        worst_apart = max(worst_apart, apart)
        worst_waste = max(worst_waste, waste)
        wastes.append(getattr(res, metric))
        fails.append(res.n_failures)
        moved.append(ints)
    mlp._init_params = init
    if moved:
        pools = ("" if args.apart is None else
                 f" outside {args.apart} ({args.apart}: {worst_apart:.3e})")
        print(f"spread over {args.samples} moves: allocation rel "
              f"{worst_alloc:.3e}{pools}, wastage rel {worst_waste:.3e}; "
              f"{metric} "
              f"{min(wastes)!r}..{max(wastes)!r}, n_failures "
              f"{min(fails)}..{max(fails)}, integer choices moved "
              f"{min(moved)}..{max(moved)}")
    if args.port:
        res, d1, b1 = replay(args.workflow, args.scale, args.method,
                             port=True)
        compare("port on the CPU", base, d0, b0, res, d1, b1, metric,
                args.apart)


def compare(label: str, base, d0, b0, res, d1, b1, metric: str,
            apart: str | None = None):
    """Print how far a replay moved from the unperturbed reference in
    allocations (those of the pool ``apart`` on their own), the wastage
    ``metric``, integer choices, boundaries and failures."""
    if len(d0) != len(d1):
        # a moved failure changes the retries, and with them the decisions
        print(f"{label}: {len(d1)} decisions against {len(d0)}; compared "
              f"pairwise up to the shorter")
    rel = [(a.task_type == apart,
            abs(a.allocation_gb - b.allocation_gb) / a.allocation_gb)
           for a, b in zip(d0, d1) if a.source == "model"]
    alloc = max((r for inside, r in rel if not inside), default=0.0)
    alloc_apart = max((r for inside, r in rel if inside), default=0.0)
    waste = abs(getattr(base, metric) - getattr(res, metric)) \
        / getattr(base, metric)
    ints = sum(a.source != b.source or (
        a.source == "model" and (a.offset_idx != b.offset_idx
                                 or np.argmax(a.raq) != np.argmax(b.raq)))
        for a, b in zip(d0, d1))
    moved = sum(x != y for x, y in zip(b0, b1))
    pool = "" if apart is None else \
        f" outside {apart} ({apart}: {alloc_apart:.3e})"
    print(f"{label}: max alloc rel {alloc:.3e}{pool}, wastage rel "
          f"{waste:.3e} "
          f"({metric} {getattr(res, metric)!r}), integer "
          f"choices moved {ints}, boundaries moved {moved}, failures "
          f"{base.n_failures} -> {res.n_failures}")
    return alloc, alloc_apart, waste, ints


if __name__ == "__main__":
    main()
