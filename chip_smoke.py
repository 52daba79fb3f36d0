#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, without the final result line):
  1. the card's name and power limit (nvidia-smi); no CUDA device -> exit;
  2. build the CUDA kernels from the sources in the checkout (one nvcc per
     source, all at once) and print the build time and ptxas report;
  3. hold each kernel against its plain PyTorch version on the card;
  4. replay the ``methylseq`` workflow at scale 1.0 through
     ``SizeyMethod(device="cuda")`` with the launch counters zeroed just
     before; every kernel must have launched, once per predictor dispatch,
     and the wastage and failures must lie within the JAX reference's own
     spread; every shape the kernels were given is then checked as in 3;
  5. replay the same workflow at a small scale on the card and on the CPU
     through the port and compare the decisions;
  6. time each kernel, its plain version and a one-call library yardstick
     with CUDA events, beside the least time the card could take.

The last three lines are the card's name and power limit, one JSON object
with a row per kernel, and ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and fp32 rate
# outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

MAIN_SCALE = 1.0      # phase 4: the whole methylseq trace (953 tasks)
# phase 4 against the JAX reference, which this script cannot import: its
# replay of the same trace on a CPU and the spread of that replay under
# 1-ulp moves of the MLP's initial weights (tools/port_tolerance.py
# --scale 1.0: wastage 5738.82..5826.43 GB.h, 1.011e-2 relative at most;
# failures 71..73, 2 at most). At this scale one rounding difference in a
# 300-step Adam fit moves tens of integer choices, so the port is held to
# twice that spread, not to the reference's decisions.
REF_WASTAGE_GBH = 5768.136342526117
REF_FAILURES = 71
REF_WASTAGE_RTOL = 2e-2
REF_FAILURES_TOL = 4
# phase 5, card vs CPU: the scale at which the reference's own replay keeps
# every integer choice under 1-ulp moves of the MLP's initial weights
# (tools/port_tolerance.py: none moves at 0.05; at 0.1 two to four move
# and one allocation moves by 1.5e-2, so equal integer choices cannot be
# asked of two devices there)
SMALL_SCALE = 0.05
# the same tolerances as the port-vs-reference test (tests/test_torch_slice.py):
# twice the reference's own spread at SMALL_SCALE (5.3e-3 on an
# allocation, 9.2e-5 on the wastage)
ALLOC_RTOL = 1e-2
WASTAGE_RTOL = 2e-4
K1_TOL = 1e-5         # |kernel - plain| <= K1_TOL * (1 + |plain|)

# (M, T, d, h) and (Q, T, d). The main path gives K1 (1, K, 1, 32) on a
# predict of K tasks and (1, CAP, 1, 32) on an observe or refresh, and K2
# (K, CAP, 1) and (CAP, CAP, 1): the in-sample refresh queries every row of
# the pool's buffer, CAP = 128 rows, doubled to 256 by methylseq's largest
# pool at scale 1.0. Phase 4 records the shapes it launched, and any it
# launched that is not listed here is checked after it.
K1_SHAPES = [(1, 1, 1, 32), (1, 7, 1, 32), (1, 128, 1, 32), (1, 256, 1, 32),
             (1, 1024, 1, 32), (3, 300, 4, 32)]
K2_SHAPES = [(1, 128, 1), (64, 128, 1), (128, 128, 1), (256, 256, 1),
             (1024, 1024, 1), (37, 300, 4)]
# K2 keeps its k nearest in a register list of 5 for k <= 5 (the main
# path's k = 5) and of 32 above: both are checked
K2_KS = (5, 1, 8, 32)
K1_TIMED = [1, 64, 128, 256, 1024]
K2_TIMED = [(1, 128), (64, 128), (128, 128), (256, 256), (1024, 1024)]


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _fail(msg: str) -> None:
    raise AssertionError(msg)


# ----------------------------------------------------------- phase 2
def build_kernels():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    times = _build.build()
    wall = time.perf_counter() - t0
    print(f"[build] {wall:.2f} s wall; per kernel "
          + ", ".join(f"{k}={v:.2f}s" for k, v in times.items()))
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill", "smem")):
                print(f"[build] {name}: {line.strip()}")


# ----------------------------------------------------------- phase 3
def _k1_inputs(m, t, d, h, seed, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    return (f(m, t, d), f(m, d, h, sc=0.5), f(m, h, sc=0.1),
            f(m, h, 1, sc=0.5), f(m, 1, sc=0.1))


def _k2_inputs(q, t, d, seed, dev, ties: bool):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if ties:   # integer-valued features: many equal distances
        qs = rng.integers(0, 6, (q, d)).astype(np.float32)
        hist = rng.integers(0, 6, (t, d)).astype(np.float32)
    else:
        qs = rng.standard_normal((q, d)).astype(np.float32)
        hist = rng.standard_normal((t, d)).astype(np.float32)
    ys = (rng.standard_normal(t) * 10).astype(np.float32)
    mask = np.ones(t, np.float32)
    mask[int(t * 0.7):] = 0.0          # masked tail, as a history buffer
    mask[rng.random(t) < 0.1] = 0.0    # and scattered holes
    scale = rng.uniform(0.5, 2.0, d).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev)
    return to(qs), to(hist), to(ys), to(mask), to(scale)


def check_kernels(k1_shapes=K1_SHAPES, k2_shapes=K2_SHAPES,
                  ks=K2_KS) -> dict:
    """Every kernel against its plain version on the card, K2 with and
    without ties and at each k of ``ks``. Returns the largest absolute
    difference per kernel."""
    import torch
    from repro_torch.kernels.ensemble_mlp.ops import ensemble_mlp_forward
    from repro_torch.kernels.ensemble_mlp.ref import ensemble_mlp_ref
    from repro_torch.kernels.knn.ops import knn_predict, pairwise_sq_dists
    from repro_torch.kernels.knn.ref import (knn_predict_ref,
                                             pairwise_sq_dists_ref)
    dev = torch.device("cuda")
    err = {"ensemble_mlp": 0.0, "knn_predict": 0.0}
    for i, (m, t, d, h) in enumerate(k1_shapes):
        args = _k1_inputs(m, t, d, h, i, dev)
        got = ensemble_mlp_forward(*args)
        want = ensemble_mlp_ref(*args)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        e = float(diff.max())
        ok = bool((diff <= K1_TOL * (1 + want.abs())).all())
        print(f"[check] ensemble_mlp M={m} T={t} d={d} h={h}: max abs err "
              f"{e:.3e} (tol {K1_TOL:g} x (1+|plain|)) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"ensemble_mlp disagrees at {(m, t, d, h)}")
        err["ensemble_mlp"] = max(err["ensemble_mlp"], e)
    for i, (q, t, d) in enumerate(k2_shapes):
        for ties in (False, True):
            qs, hist, ys, mask, scale = _k2_inputs(q, t, d, 100 + i, dev,
                                                   ties)
            e = 0.0
            for k in ks:
                got = knn_predict(qs, hist, ys, mask, scale, k)
                want = knn_predict_ref(qs, hist, ys, mask, scale, k)
                torch.cuda.synchronize()
                e = max(e, float((got - want).abs().max()))
                if not torch.equal(got, want):
                    _fail(f"knn_predict disagrees at {(q, t, d, ties)}, "
                          f"k={k}")
            print(f"[check] knn_predict Q={q} T={t} d={d} ties={ties} "
                  f"k={','.join(map(str, ks))}: max abs err {e:.3e} (tol: "
                  f"bitwise equal) ok")
            err["knn_predict"] = max(err["knn_predict"], e)
            one = torch.ones_like(scale)
            got = pairwise_sq_dists(qs, hist, mask)
            want = pairwise_sq_dists_ref(qs, hist, mask)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                _fail(f"pairwise_sq_dists disagrees at {(q, t, d, ties)}")
            # with scale = 1 the fused kernel's distances are these
            nn = knn_predict(qs, hist, ys, mask, one, 5)
            if not torch.equal(nn, knn_predict_ref(qs, hist, ys, mask,
                                                   one, 5)):
                _fail(f"knn_predict (scale 1) disagrees at {(q, t, d)}")
    if k2_shapes:
        print("[check] pairwise_sq_dists (the TPU kernel's own function): "
              "bitwise equal to its plain version at these K2 shapes")
    return err


# ----------------------------------------------------------- phase 4/5
def _replay(scale: float, device: str):
    import numpy as np
    from repro_torch.baselines import SizeyMethod
    from repro_torch.workflow import generate_workflow, simulate
    method = SizeyMethod(device=device)
    decisions = []
    predict = method.predictor.predict

    def recording(*a, **k):
        d = predict(*a, **k)
        decisions.append(d)
        return d

    method.predictor.predict = recording
    trace = generate_workflow("methylseq", scale=scale)
    t0 = time.perf_counter()
    res = simulate(trace, method)
    wall = time.perf_counter() - t0
    if len(res.outcomes) != len(trace.tasks):
        _fail("replay lost tasks")
    allocs = np.asarray([d.allocation_gb for d in decisions])
    if not (np.all(np.isfinite(allocs)) and np.all(allocs > 0)
            and np.isfinite(res.wastage_gbh)):
        _fail("replay produced non-finite or non-positive allocations")
    return res, decisions, wall


def _recording_shapes():
    """Wrap the models' kernel calls to count the shapes they pass: K1 as
    (M, T, d, h), K2 as (Q, T, d). The wrappers' own counters are left to
    count the launches."""
    from collections import Counter

    from repro_torch.core.models import knn, mlp
    shapes = {"ensemble_mlp": Counter(), "knn_predict": Counter()}
    k1, k2 = mlp.ensemble_mlp_forward, knn.knn_predict

    def rec_k1(x, w1, *a):
        shapes["ensemble_mlp"][(*x.shape, w1.shape[2])] += 1
        return k1(x, w1, *a)

    def rec_k2(queries, hist, *a):
        shapes["knn_predict"][(*queries.shape[:1], *hist.shape)] += 1
        return k2(queries, hist, *a)

    mlp.ensemble_mlp_forward, knn.knn_predict = rec_k1, rec_k2

    def restore():
        mlp.ensemble_mlp_forward, knn.knn_predict = k1, k2
    return shapes, restore


def main_path() -> dict:
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    before = dict(P.DISPATCH_COUNTS)
    shapes, restore = _recording_shapes()
    reset_launch_counts()
    try:
        res, _decs, wall = _replay(MAIN_SCALE, "cuda")
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(KERNEL_LAUNCHES)
    disp = {k: P.DISPATCH_COUNTS[k] - before.get(k, 0)
            for k in ("predict_pool", "observe_pool", "refresh_pool")}
    n = len(res.outcomes)
    print(f"[main] methylseq scale={MAIN_SCALE}: tasks={n} "
          f"wastage_gbh={res.wastage_gbh!r} n_failures={res.n_failures} "
          f"wall_s={wall:.3f} tasks_per_s={n / wall:.3f}")
    print(f"[main] dispatches {disp}; kernel launches {launches}")
    for name, counts in shapes.items():
        print(f"[main] {name} shapes, most launched first: "
              + ", ".join(f"{s}x{c}" for s, c in counts.most_common()))
    wrel = abs(res.wastage_gbh - REF_WASTAGE_GBH) / REF_WASTAGE_GBH
    print(f"[main] against the reference's replay (wastage_gbh "
          f"{REF_WASTAGE_GBH!r}, n_failures {REF_FAILURES}): wastage rel "
          f"diff {wrel:.3e} (tol {REF_WASTAGE_RTOL:g}), failures diff "
          f"{res.n_failures - REF_FAILURES} (tol {REF_FAILURES_TOL})")
    if wrel > REF_WASTAGE_RTOL \
            or abs(res.n_failures - REF_FAILURES) > REF_FAILURES_TOL:
        _fail("the card's replay is outside the reference's spread")
    expect = sum(disp.values())
    for name in ("ensemble_mlp", "knn_predict"):
        if launches.get(name, 0) <= 0:
            _fail(f"{name} was never launched on the main path")
        if launches[name] != expect:
            _fail(f"{name}: {launches[name]} launches, expected one per "
                  f"dispatch ({expect})")
    return {"launches": launches, "tasks": n, "wall_s": wall,
            "shapes": shapes, "wastage_gbh": res.wastage_gbh,
            "n_failures": res.n_failures}


def card_vs_cpu() -> None:
    import numpy as np
    import torch
    rg, dg, _ = _replay(SMALL_SCALE, "cuda")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # thousands of tiny ops: one thread is faster
    try:
        rc, dc, _ = _replay(SMALL_SCALE, "cpu")
    finally:
        torch.set_num_threads(threads)
    if len(dg) != len(dc):
        _fail("card and CPU took different numbers of decisions")
    mism, worst = 0, 0.0
    for a, b in zip(dg, dc):
        if a.source != b.source:
            _fail("card and CPU disagree on preset vs model")
        if a.source == "model":
            if (a.offset_idx != b.offset_idx
                    or int(np.argmax(a.raq)) != int(np.argmax(b.raq))):
                mism += 1
            worst = max(worst, abs(a.allocation_gb - b.allocation_gb)
                        / abs(b.allocation_gb))
    wrel = abs(rg.wastage_gbh - rc.wastage_gbh) / abs(rc.wastage_gbh)
    print(f"[parity] methylseq scale={SMALL_SCALE}: {len(dg)} decisions; "
          f"integer mismatches {mism}; max alloc rel diff {worst:.3e} "
          f"(tol {ALLOC_RTOL:g}); failures card={rg.n_failures} "
          f"cpu={rc.n_failures}; wastage rel diff {wrel:.3e} "
          f"(tol {WASTAGE_RTOL:g})")
    if mism or rg.n_failures != rc.n_failures:
        _fail("card and CPU disagree on an integer choice")
    if worst > ALLOC_RTOL or wrel > WASTAGE_RTOL:
        _fail("card and CPU disagree beyond the stated tolerance")


# ----------------------------------------------------------- phase 6
def _time_ms(fn, reps: int = 60, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call."""
    import statistics
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _bound(nbytes: int, flops: int):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the fp32 operations over the fp32 rate."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / FP32_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _k1_bound(m, t, d, h):
    # each input read once, the output written once; per row: the d-long
    # dot, the bias, tanh and the multiply-add into the output, per unit
    return _bound(4 * (m * t * d + m * d * h + 2 * m * h + m + m * t),
                  m * t * h * (2 * d + 4))


def _k2_bound(q, t, d, n_valid):
    # per (query, valid row): subtract, divide, multiply-add per feature and
    # one comparison against the k-th best (masked rows are skipped)
    return _bound(4 * (q * d + t * d + 2 * t + d + q),
                  q * n_valid * (3 * d + 1))


def time_kernels(k1_ts=K1_TIMED, k2_qts=K2_TIMED) -> dict:
    import torch
    from repro_torch.kernels.ensemble_mlp.ops import ensemble_mlp_forward
    from repro_torch.kernels.ensemble_mlp.ref import ensemble_mlp_ref
    from repro_torch.kernels.knn.ops import knn_predict
    from repro_torch.kernels.knn.ref import knn_predict_ref
    dev = torch.device("cuda")
    rows = {}
    for t in k1_ts:
        x, w1, b1, w2, b2 = _k1_inputs(1, t, 1, 32, 7, dev)

        def library(x=x, w1=w1, b1=b1, w2=w2, b2=b2):
            hid = torch.baddbmm(b1[:, None, :], x, w1).tanh_()
            return torch.baddbmm(b2[:, None, :], hid, w2)

        bound, by = _k1_bound(1, t, 1, 32)
        r = {"ms": _time_ms(lambda: ensemble_mlp_forward(x, w1, b1, w2, b2)),
             "plain_ms": _time_ms(lambda: ensemble_mlp_ref(x, w1, b1, w2,
                                                           b2)),
             "bound_ms": bound, "bound_by": by,
             "library_ms": _time_ms(library)}
        rows[("ensemble_mlp", t)] = r
        print(f"[time] ensemble_mlp M=1 T={t} d=1 h=32: kernel "
              f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
              f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.3e} ms "
              f"({by})")
    for q, t in k2_qts:
        qs, hist, ys, mask, scale = _k2_inputs(q, t, 1, 11, dev, False)
        n_valid = int((mask > 0).sum())

        def library(qs=qs, hist=hist, ys=ys, mask=mask, scale=scale):
            d2 = torch.cdist(qs / scale, hist / scale)
            d2 = d2.masked_fill(mask[None, :] <= 0, float("inf"))
            _v, idx = torch.topk(d2, 5, largest=False)
            return ys[idx].mean(-1)

        bound, by = _k2_bound(q, t, 1, n_valid)
        r = {"ms": _time_ms(lambda: knn_predict(qs, hist, ys, mask, scale,
                                                5)),
             "plain_ms": _time_ms(lambda: knn_predict_ref(qs, hist, ys, mask,
                                                          scale, 5)),
             "bound_ms": bound, "bound_by": by,
             "library_ms": _time_ms(library)}
        rows[("knn_predict", (q, t))] = r
        print(f"[time] knn_predict Q={q} T={t} d=1 k=5: kernel "
              f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
              f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.3e} ms "
              f"({by})")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    gpu = gpu_line()
    print(f"[gpu] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    build_kernels()
    errors = check_kernels()
    main = main_path()
    # every shape the main path launched is held against the plain version
    k1_seen = [s for s in main["shapes"]["ensemble_mlp"] if s not in K1_SHAPES]
    k2_seen = [s for s in main["shapes"]["knn_predict"] if s not in K2_SHAPES]
    if k1_seen or k2_seen:
        more = check_kernels(k1_seen, k2_seen, ks=(5,))
        errors = {k: max(v, more[k]) for k, v in errors.items()}
    card_vs_cpu()
    # the JSON rows are timed at the shape the main path launched most
    # (d = 1, h = 32 on this path: the timed inputs use those)
    k1_row = main["shapes"]["ensemble_mlp"].most_common(1)[0][0]
    k2_row = main["shapes"]["knn_predict"].most_common(1)[0][0]
    if k1_row[0] != 1 or k1_row[2:] != (1, 32) or k2_row[2] != 1:
        _fail(f"main path launched unexpected shapes {k1_row}, {k2_row}")
    timings = time_kernels(
        sorted(set(K1_TIMED) | {k1_row[1]}),
        sorted(set(K2_TIMED) | {k2_row[:2]}))
    k1 = timings[("ensemble_mlp", k1_row[1])]
    k2 = timings[("knn_predict", k2_row[:2])]
    print(f"[time] JSON rows at the most launched shapes: ensemble_mlp "
          f"(M,T,d,h)={k1_row}, knn_predict (Q,T,d)={k2_row}")
    kernels = [
        {"name": "ensemble_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/ensemble_mlp/kernel.cu",
         "replaces": "src/repro/kernels/ensemble_mlp/kernel.py:29",
         "launches": main["launches"]["ensemble_mlp"],
         "max_abs_err": errors["ensemble_mlp"], **k1},
        {"name": "knn_predict", "route": "cuda",
         "source": "src/repro_torch/kernels/knn/kernel.cu",
         "replaces": "src/repro/kernels/knn/kernel.py:40",
         "launches": main["launches"]["knn_predict"],
         "max_abs_err": errors["knn_predict"], **k2},
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
