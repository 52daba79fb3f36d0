"""Find where the port's replay first leaves the reference's, and why.

Replays a workflow through the JAX package and through the port on the
CPU, and prints every model decision (up to ``--show``) whose offset
index or best model differs, or whose allocation differs by more than
``--rtol``, with both packages' per-model predictions. For the first
such decision whose MLP prediction differs, it refits that pool's MLP
from the reference's buffers and seed in both packages and prints each
learning rate's final loss, the loss of the lr-0.03 run after a few step
counts in both packages, and the reference's losses under 1-ulp moves of
its initial weights.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/port_divergence.py \
        [--workflow methylseq] [--scale 0.1] [--method sizey]

``--method sizey_temporal`` follows the temporal path: one decision per
segment, the MLP fit on the pool's (features, segment centre) rows.

Its output at methylseq scale 0.1 is quoted in ROADMAP.md (Queue 3) and
PERF.md.
"""
from __future__ import annotations

import argparse

import numpy as np

MLP = 2   # index of the MLP in the default pool ("linear", "knn", "mlp", "forest")


def replay(port: bool, workflow: str, scale: float, method_name: str):
    """Replay recording, in order, each decision and each pool's full
    refit (the buffers and the seed the refit was given)."""
    if port:
        import torch

        from repro_torch.baselines import make_method
        from repro_torch.workflow import generate_workflow, simulate
        torch.set_num_threads(1)
        method = make_method(method_name, device="cpu")
    else:
        from repro.baselines import make_method
        from repro.workflow import generate_workflow, simulate
        method = make_method(method_name)
    temporal = method_name == "sizey_temporal"
    pred = method.predictor.predictor if temporal else method.predictor
    events = []
    refit = pred._refit_fused

    def recording_refit(key, pool, seed, mask=None):
        events.append(("fit", key[0], np.array(pool.xs), np.array(pool.ys),
                       np.array(pool.mask if mask is None else mask), seed))
        return refit(key, pool, seed, mask)

    if not port:
        pred._refit_fused = recording_refit
    if temporal:
        predict_batch = method.predictor.predict_batch

        def recording_batch(tasks):
            out = predict_batch(tasks)
            for d in out:
                events.extend(("decision", s) for s in d.seg_decisions)
            return out

        method.predictor.predict_batch = recording_batch
    else:
        predict = pred.predict

        def recording_predict(*a, **k):
            d = predict(*a, **k)
            events.append(("decision", d))
            return d

        pred.predict = recording_predict
    res = simulate(generate_workflow(workflow, scale=scale), method)
    return res, events


def mlp_losses(xs, ys, mask, seed, steps, init_move=None):
    """The reference's and the port's final loss per HPO learning rate
    (and the reference's alone if ``init_move`` moves its init)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core.config import SizeyConfig as JConfig
    from repro.core.models import mlp as jmlp
    from repro_torch.core import prng
    from repro_torch.core.models import mlp as tmlp
    n_steps = JConfig().mlp_train_steps if steps is None else steps
    jx, jy, jm = (jnp.asarray(a) for a in (xs, ys, mask))
    mu_x, sd_x, mu_y, sd_y = jmlp._norm_stats(jx, jy, jm)
    xn, yn = (jx - mu_x) / sd_x, (jy - mu_y) / sd_y
    p0 = jmlp._init_params(jax.random.PRNGKey(seed), xs.shape[1], 32)
    if init_move is not None:
        which, direction = init_move
        w1, b1, w2, b2 = p0
        if which == "w1":
            w1 = jnp.nextafter(w1, direction)
        else:
            w2 = jnp.nextafter(w2, direction)
        p0 = (w1, b1, w2, b2)
    zeros = jax.tree.map(jnp.zeros_like, p0)
    ref = []
    for lr in jmlp.HPO_LRS:
        p, _m, _v, _t = jmlp._adam_steps(p0, zeros, zeros,
                                         jnp.zeros((), jnp.float32), xn, yn,
                                         jm, lr, n_steps)
        ref.append(float(jmlp._loss(p, xn, yn, jm)))
    if init_move is not None:
        return ref, None
    tx, ty, tm = (torch.from_numpy(a) for a in (xs, ys, mask))
    mu_x, sd_x, mu_y, sd_y = tmlp._norm_stats(tx, ty, tm)
    txn, tyn = (tx - mu_x) / sd_x, (ty - mu_y) / sd_y
    lrs = torch.tensor(tmlp.HPO_LRS)
    flat0 = torch.from_numpy(tmlp.init_params(
        prng.prng_key(seed), xs.shape[1], 32)).expand(len(lrs), -1)
    zz = torch.zeros_like(flat0)
    flat, _m, _v, _t = tmlp._adam_steps(flat0, zz, zz, torch.zeros(()), txn,
                                        tyn, tm, lrs[:, None], n_steps,
                                        xs.shape[1], 32)
    port = tmlp._loss(flat, txn, tyn, tm, tm.sum(), xs.shape[1], 32).tolist()
    return ref, port


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workflow", default="methylseq")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--rtol", type=float, default=1e-2)
    ap.add_argument("--show", type=int, default=10)
    ap.add_argument("--method", default="sizey",
                    choices=("sizey", "sizey_temporal"))
    args = ap.parse_args()
    import jax.numpy as jnp

    rj, ej = replay(False, args.workflow, args.scale, args.method)
    rt, et = replay(True, args.workflow, args.scale, args.method)
    print(f"{args.workflow} scale={args.scale}: failures reference "
          f"{rj.n_failures}, port {rt.n_failures}; wastage_gbh reference "
          f"{rj.wastage_gbh!r}, port {rt.wastage_gbh!r}")
    dj = [e[1] for e in ej if e[0] == "decision"]
    dt = [e[1] for e in et if e[0] == "decision"]
    shown, first_mlp = 0, None
    for i, (a, b) in enumerate(zip(dj, dt)):
        if a.source != "model":
            continue
        rel = abs(a.allocation_gb - b.allocation_gb) / a.allocation_gb
        if (a.offset_idx == b.offset_idx and rel <= args.rtol
                and np.argmax(a.raq) == np.argmax(b.raq)):
            continue
        if shown < args.show:
            print(f"decision {i} pool {a.task_type} features {a.features}: "
                  f"offset_idx {a.offset_idx}/{b.offset_idx}, best "
                  f"{np.argmax(a.raq)}/{np.argmax(b.raq)}, allocation "
                  f"{a.allocation_gb:.4f}/{b.allocation_gb:.4f} (rel "
                  f"{rel:.2e}); model preds reference "
                  f"{np.round(np.asarray(a.model_preds), 4).tolist()} port "
                  f"{np.round(np.asarray(b.model_preds), 4).tolist()}")
            shown += 1
        mj, mt = float(a.model_preds[MLP]), float(b.model_preds[MLP])
        if first_mlp is None and abs(mj - mt) > args.rtol * abs(mj):
            first_mlp = i
    if first_mlp is None:
        print("no MLP prediction differs beyond rtol")
        return
    # the refit that preceded that decision in the reference's replay
    seen, fit = 0, None
    for e in ej:
        if e[0] == "decision":
            if seen == first_mlp:
                break
            seen += 1
        elif e[1] == dj[first_mlp].task_type:
            fit = e
    _, pool, xs, ys, mask, seed = fit
    live = mask > 0
    print(f"first MLP divergence: decision {first_mlp}, pool {pool} with "
          f"{int(live.sum())} rows, fit seed {seed}; xs "
          f"{xs[live].tolist()} ys {ys[live].tolist()}")
    ref, port = mlp_losses(xs, ys, mask, seed, None)
    print(f"final loss per lr {[0.03, 0.01, 0.003]}: reference {ref}, "
          f"port {port}")
    for steps in (1, 50, 100, 150, 200, 250, 300):
        ref, port = mlp_losses(xs, ys, mask, seed, steps)
        print(f"lr 0.03 after {steps} steps: reference {ref[0]:.6e}, port "
              f"{port[0]:.6e}")
    for which in ("w1", "w2"):
        for direction in (jnp.inf, -jnp.inf):
            ref, _ = mlp_losses(xs, ys, mask, seed, None,
                                (which, direction))
            print(f"reference, {which} {'+' if direction > 0 else '-'}1 "
                  f"ulp: final loss per lr {ref}")


if __name__ == "__main__":
    main()
