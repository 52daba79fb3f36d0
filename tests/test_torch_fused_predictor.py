"""The port's per-model loop (``SizeyPredictor(fused=False)``) against its
fused single-dispatch path and against the reference's loop, on the CPU.

The port's counterpart of ``tests/test_fused_predictor.py:55-92``: the
fused path reproduces the loop decision for decision across gating
strategies and adaptive alpha, across a buffer-growth boundary, and in the
full-retrain mode (the same tolerances: 1e-5, the offset 1e-4). The port's
loop is then held to the reference's loop on the same workload with the
predictor tolerances of PERF.md section 2: allocations within 1e-2 (twice
the reference's own spread under 1-ulp moves of the MLP's initial
weights), integer choices (source, offset strategy, best model) equal.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core.predictor as JP  # noqa: E402
from repro.core.config import SizeyConfig as JConfig  # noqa: E402
import repro_torch.core.predictor as TP  # noqa: E402
import repro_torch.core.provenance as provenance_mod  # noqa: E402
from repro_torch.core.config import SizeyConfig  # noqa: E402
from repro_torch.core.predictor import SizeyPredictor, TaskQuery  # noqa: E402

ATOL = 1e-5
ALLOC_RTOL = 1e-2


def _workload(n, seed=0):
    """Deterministic (x, peak, runtime) stream with a nonlinear memory law."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0.5, 8.0, n)
    peaks = 1.0 + 0.4 * xs ** 2 + rng.normal(0.0, 0.15, n)
    rts = rng.uniform(0.2, 1.0, n)
    return [(float(x), float(max(p, 0.1)), float(r))
            for x, p, r in zip(xs, peaks, rts)]


def _drive(p, workload, probe_every=4):
    """Feed the workload; return the decisions taken at probe points."""
    probes = []
    for i, (x, peak, rt) in enumerate(workload):
        d = p.predict("t", "m", (x,), 32.0)
        if i % probe_every == 0:
            probes.append(d)
        p.observe(d, peak, rt)
    return probes


def _assert_decisions_close(a, b):
    assert a.source == b.source
    np.testing.assert_allclose(a.allocation_gb, b.allocation_gb, atol=ATOL,
                               rtol=1e-5)
    if a.source == "model":
        for f in ("model_preds", "weights"):
            np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                       np.asarray(getattr(b, f)), atol=ATOL,
                                       rtol=1e-5)
        np.testing.assert_allclose(a.agg_pred_gb, b.agg_pred_gb, atol=ATOL,
                                   rtol=1e-5)
        np.testing.assert_allclose(a.offset_gb, b.offset_gb, atol=ATOL,
                                   rtol=1e-4)
        assert a.offset_idx == b.offset_idx


def _port(cfg, fused):
    return SizeyPredictor(cfg, fused=fused, device="cpu")


@pytest.mark.parametrize("strategy", ["interpolation", "argmax"])
@pytest.mark.parametrize("adaptive_alpha", [False, True])
def test_fused_matches_per_model_loop(strategy, adaptive_alpha):
    cfg = SizeyConfig(strategy=strategy, adaptive_alpha=adaptive_alpha,
                      incremental=True, mlp_train_steps=40)
    workload = _workload(24)
    fused = _drive(_port(cfg, True), workload)
    loop = _drive(_port(cfg, False), workload)
    assert len(fused) == len(loop)
    for a, b in zip(fused, loop):
        _assert_decisions_close(a, b)


def test_fused_matches_loop_across_growth_boundary(monkeypatch):
    monkeypatch.setattr(provenance_mod, "INITIAL_CAP", 8)
    cfg = SizeyConfig(incremental=True, mlp_train_steps=30)
    workload = _workload(20)  # crosses cap 8 -> 32
    fused = _drive(_port(cfg, True), workload, probe_every=2)
    loop = _drive(_port(cfg, False), workload, probe_every=2)
    assert any(d.source == "model" for d in loop)
    for a, b in zip(fused, loop):
        _assert_decisions_close(a, b)


def test_fused_matches_loop_full_retrain():
    cfg = SizeyConfig(incremental=False, mlp_train_steps=30)
    workload = _workload(10)
    for a, b in zip(_drive(_port(cfg, True), workload),
                    _drive(_port(cfg, False), workload)):
        _assert_decisions_close(a, b)


def test_loop_batches_observe_waves_and_warm_starts_as_the_fused_path(
        tmp_path):
    """predict_batch, observe_batch and warm_start on the loop decide as
    the fused path does, and the loop counts no dispatch."""
    from repro_torch.core.provenance import ProvenanceDB
    cfg = SizeyConfig(mlp_train_steps=30)
    wl = _workload(12, seed=3)
    runs = {}
    for fused in (True, False):
        path = str(tmp_path / f"prov_{fused}.jsonl")
        p = SizeyPredictor(cfg, ProvenanceDB(persist_path=path,
                                             device="cpu"),
                           fused=fused, device="cpu")
        before = dict(TP.DISPATCH_COUNTS)
        for i in range(0, len(wl), 3):
            wave = wl[i:i + 3]
            ds = p.predict_batch([TaskQuery("t", "m", (x,), 32.0)
                                  for x, _, _ in wave])
            p.observe_batch([(d, peak, rt, 1, "") for d, (_, peak, rt)
                             in zip(ds, wave)])
        moved = {k: v - before.get(k, 0)
                 for k, v in TP.DISPATCH_COUNTS.items()}
        w = SizeyPredictor(cfg, ProvenanceDB(persist_path=path,
                                             device="cpu"),
                           fused=fused, device="cpu")
        w.warm_start()
        runs[fused] = (ds, [w.predict("t", "m", (x,), 32.0)
                            for x in (1.0, 4.0, 7.5)], moved)
    assert not any(runs[False][2].values())
    assert runs[True][2]["observe_pool"] > 0
    for a, b in zip(runs[True][0] + runs[True][1],
                    runs[False][0] + runs[False][1]):
        _assert_decisions_close(a, b)


@pytest.mark.parametrize("kw", [
    {},
    {"strategy": "argmax"},
    {"adaptive_alpha": True},
    {"incremental": True},
], ids=["default", "argmax", "adaptive_alpha", "incremental"])
def test_loop_matches_the_reference_loop(kw):
    """The port's loop against the reference's loop (``fused=False`` in
    both), decision by decision on the same stream."""
    kw = {"mlp_train_steps": 60, **kw}
    workload = _workload(20, seed=2)
    want = _drive(JP.SizeyPredictor(JConfig(**kw), fused=False), workload,
                  probe_every=1)
    got = _drive(_port(SizeyConfig(**kw), False), workload, probe_every=1)
    assert len(got) == len(want)
    n_model = 0
    for a, b in zip(want, got):
        assert a.source == b.source
        np.testing.assert_allclose(b.allocation_gb, a.allocation_gb,
                                   rtol=ALLOC_RTOL)
        if a.source == "model":
            n_model += 1
            assert a.offset_idx == b.offset_idx
            assert int(np.argmax(a.raq)) == int(np.argmax(b.raq))
            # linear, k-NN, forest: no training noise
            np.testing.assert_allclose(b.model_preds[[0, 1, 3]],
                                       a.model_preds[[0, 1, 3]], rtol=1e-4)
    assert n_model > 0
