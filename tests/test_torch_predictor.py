"""The port's SizeyPredictor against the reference's, on the CPU.

A predict/observe stream is compared decision by decision; integer
choices (preset vs model, offset strategy, best model) must be equal and
allocations agree within ALLOC_RTOL. Also: power-of-two batch buckets,
observe waves, the amortized-refit schedule, and JSONL checkpoints written
by one package and loaded by the other.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the port runs thousands of tiny ops per replay: one intra-op thread per
# test process (the suite runs several) is faster than a spinning pool
torch.set_num_threads(1)

import repro.core.predictor as JP  # noqa: E402
from repro.core.config import SizeyConfig as JConfig  # noqa: E402
from repro.core.provenance import ProvenanceDB as JDB  # noqa: E402
from repro.core.provenance import TaskRecord as JRecord  # noqa: E402
import repro_torch.core.predictor as TP  # noqa: E402
from repro_torch.core.config import SizeyConfig  # noqa: E402
from repro_torch.core.provenance import ProvenanceDB  # noqa: E402
from repro_torch.core.provenance import TaskRecord  # noqa: E402

# The reference's own spread: tools/port_tolerance.py moves the MLP's
# initial weights by one ulp and replays methylseq at scale 0.05; the
# allocations then move by up to 5.3e-3 (relative). The port differs from
# the reference by rounding in every Adam step, so it is held to twice
# that spread.
ALLOC_RTOL = 1e-2


def _workload(n, seed=0):
    """(x, peak, runtime) stream with a nonlinear memory law."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0.5, 8.0, n)
    peaks = 1.0 + 0.4 * xs ** 2 + rng.normal(0.0, 0.15, n)
    rts = rng.uniform(0.2, 1.0, n)
    return [(float(x), float(max(p, 0.1)), float(r))
            for x, p, r in zip(xs, peaks, rts)]


def _drive(p, workload, pools=("t", "u")):
    decisions = []
    for i, (x, peak, rt) in enumerate(workload):
        d = p.predict(pools[i % len(pools)], "m", (x,), 32.0)
        decisions.append(d)
        p.observe(d, peak, rt)
    return decisions


def _assert_same_decisions(dj, dt):
    assert len(dj) == len(dt)
    n_model = 0
    for a, b in zip(dj, dt):
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


@pytest.mark.parametrize("kw", [
    {},                                                  # the paper's loop
    {"strategy": "argmax", "mlp_train_steps": 120},
    {"adaptive_alpha": True, "mlp_train_steps": 120},
    {"incremental": True, "mlp_train_steps": 120},
    {"refit_growth": 0.5, "mlp_train_steps": 120},
], ids=["default", "argmax", "adaptive_alpha", "incremental",
        "refit_growth"])
def test_stream_matches_reference_decision_by_decision(kw):
    wl = _workload(26, seed=1)
    jp = JP.SizeyPredictor(JConfig(**kw))
    tp = TP.SizeyPredictor(SizeyConfig(**kw), device="cpu")
    j0, t0 = dict(JP.DISPATCH_COUNTS), dict(TP.DISPATCH_COUNTS)
    _assert_same_decisions(_drive(jp, wl), _drive(tp, wl))
    for kind in ("predict_pool", "observe_pool", "refresh_pool"):
        assert (JP.DISPATCH_COUNTS[kind] - j0.get(kind, 0)
                == TP.DISPATCH_COUNTS[kind] - t0.get(kind, 0)), kind


def test_predict_batch_buckets_and_matches_predict():
    cfg = SizeyConfig(mlp_train_steps=80)
    tp = TP.SizeyPredictor(cfg, device="cpu")
    jp = JP.SizeyPredictor(JConfig(mlp_train_steps=80))
    wl = _workload(12, seed=2)
    _drive(tp, wl, pools=("t",))
    _drive(jp, wl, pools=("t",))
    queries = [TP.TaskQuery("t", "m", (x,), 32.0) for x in
               (0.7, 2.5, 3.1, 6.6, 7.9)]
    traces0 = TP.TRACE_COUNTS["predict"]
    disp0 = TP.DISPATCH_COUNTS["predict_pool"]
    batch = tp.predict_batch(queries)
    tp.predict_batch(queries[:3] + queries[:3])   # 6 -> the same bucket 8
    assert TP.DISPATCH_COUNTS["predict_pool"] == disp0 + 2
    assert TP.TRACE_COUNTS["predict"] - traces0 <= 1
    singles = [tp.predict(q.task_type, q.machine, q.features,
                          q.user_preset_gb) for q in queries]
    for a, b in zip(batch, singles):   # padding rows change nothing
        np.testing.assert_allclose(a.allocation_gb, b.allocation_gb,
                                   rtol=1e-6)
        assert a.offset_idx == b.offset_idx
    jbatch = jp.predict_batch([JP.TaskQuery(*q.__dict__.values())
                               for q in queries])
    _assert_same_decisions(jbatch, batch)


def test_observe_wave_equals_sequential_observes():
    cfg = SizeyConfig(mlp_train_steps=60)
    wl = _workload(10, seed=3)
    seq = TP.SizeyPredictor(cfg, device="cpu")
    wave = TP.SizeyPredictor(cfg, device="cpu")
    for p in (seq, wave):
        for x, peak, rt in wl[:5]:
            p.observe(p.predict("t", "m", (x,), 32.0), peak, rt)
    tail = [(seq.predict("t", "m", (x,), 32.0), peak, rt, 1, "")
            for x, peak, rt in wl[5:]]
    for obs in tail:
        seq.observe(*obs)
    wave.observe_batch(tail)
    for a, b in zip(seq._cache[("t", "m")], wave._cache[("t", "m")]):
        assert torch.equal(a, b)
    probe = [p.predict("t", "m", (4.2,), 32.0) for p in (seq, wave)]
    assert probe[0].allocation_gb == probe[1].allocation_gb


def _write_records(db, rec_cls):
    for i, (x, peak, rt) in enumerate(_workload(9, seed=4)):
        db.add(rec_cls("t", "m", (x,), peak, rt, 1 + i % 2, "wf"))
        if i >= 3:
            db.add_log("t", "m", np.asarray([peak, peak * 1.1, peak * 0.9,
                                             peak], np.float32),
                       peak * 1.05, peak, rt)
    db.add_aux("fit", {"task_type": "t", "machine": "m", "count": 9})


def test_checkpoint_files_are_byte_compatible(tmp_path):
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    _write_records(JDB(n_features=1, n_models=4, persist_path=jpath),
                   JRecord)
    _write_records(ProvenanceDB(n_features=1, n_models=4, persist_path=tpath,
                                device="cpu"), TaskRecord)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    # each package loads the other's file into the same buffers
    jdb = JDB(n_features=1, n_models=4, persist_path=tpath)
    tdb = ProvenanceDB(n_features=1, n_models=4, persist_path=jpath,
                       device="cpu")
    jpool, tpool = jdb.pool("t", "m"), tdb.pool("t", "m")
    for f in ("cap", "count", "log_cap", "log_count", "max_seen_gb"):
        assert getattr(jpool, f) == getattr(tpool, f), f
    for f in ("xs", "ys", "runtimes", "mask", "log_model_preds", "log_agg",
              "log_actual", "log_runtime", "log_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(jpool, f)),
                                      getattr(tpool, f).numpy())
    assert jdb.aux == tdb.aux


def test_warm_start_from_a_reference_checkpoint(tmp_path):
    path = str(tmp_path / "prov.jsonl")
    kw = {"mlp_train_steps": 80}
    jp = JP.SizeyPredictor(JConfig(**kw), JDB(persist_path=path))
    _drive(jp, _workload(14, seed=5))
    jw = JP.SizeyPredictor(JConfig(**kw), JDB(persist_path=path))
    jw.warm_start()
    tw = TP.SizeyPredictor(SizeyConfig(**kw),
                           ProvenanceDB(persist_path=path, device="cpu"))
    tw.warm_start()
    assert tw._fit_serial == jw._fit_serial
    probes = [(p, "m", (x,), 32.0) for p in ("t", "u") for x in (1.0, 5.5)]
    _assert_same_decisions([jw.predict(*q) for q in probes],
                           [tw.predict(*q) for q in probes])


def test_legacy_loop_and_foreign_devices_are_refused():
    # the legacy per-model loop is built and decides as the reference's
    # loop does (tests/test_torch_fused_predictor.py holds it further)
    kw = {"mlp_train_steps": 60}
    wl = _workload(10, seed=4)
    _assert_same_decisions(
        _drive(JP.SizeyPredictor(JConfig(**kw), fused=False), wl),
        _drive(TP.SizeyPredictor(SizeyConfig(**kw), fused=False,
                                 device="cpu"), wl))
    with pytest.raises(ValueError):
        TP.SizeyPredictor(db=ProvenanceDB(device="cpu"), device="meta")


def test_state_carried_across_decides_like_the_reference():
    """Pools, model states and decision cache of a reference predictor,
    carried into the port with repro_torch.convert, give the same
    decisions: the port computes the same function of the same state."""
    import jax

    from repro_torch import convert
    jp = JP.SizeyPredictor(JConfig(mlp_train_steps=60))
    _drive(jp, _workload(16, seed=6))
    tp = TP.SizeyPredictor(SizeyConfig(mlp_train_steps=60), device="cpu")
    for key, pool in jp.db.pools.items():
        arrays = convert.pool_to_numpy(pool)
        tpool = convert.pool_from_numpy(tp.db, key, arrays)
        assert convert.pool_to_numpy(tpool).keys() == arrays.keys()
        if key not in jp.states:
            continue
        tp.states[key] = tuple(
            convert.state_to_torch(m, jax.device_get(s), "cpu")
            for m, s in zip(tp.models, jp.states[key]))
        tp._cache[key] = tuple(torch.tensor(np.asarray(c))
                               for c in jp._cache[key])
    probes = [(p, "m", (x,), 32.0) for p in ("t", "u")
              for x in (0.8, 3.0, 7.7)]
    for a, b in zip([jp.predict(*q) for q in probes],
                    [tp.predict(*q) for q in probes]):
        assert a.offset_idx == b.offset_idx
        # the same state: only the forward's arithmetic differs (the MLP's
        # 32-term sum and tanh round differently, ~1e-6)
        np.testing.assert_allclose(b.model_preds, a.model_preds, rtol=1e-5)
        np.testing.assert_allclose(b.allocation_gb, a.allocation_gb,
                                   rtol=1e-5)
