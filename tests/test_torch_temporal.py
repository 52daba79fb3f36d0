"""The port's temporal path (``SizeyMethod(temporal_k=...)``, the temporal
predictor and its boundary cache) against the reference, on the CPU.

  * methylseq at scale 0.05 replays through both packages with equal
    boundaries at every decision, equal boundary-fit counts, equal integer
    choices per segment, and allocations and time-integrated wastage
    within the measured tolerance;
  * ``temporal_k=1`` is the port's peak path, bit for bit;
  * a temporal checkpoint (``curve`` aux rows) that either package writes
    restores warm in the other;
  * the port keeps the reference's refit and boundary-cache schedules.
"""
import math

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.baselines import make_method as j_make  # noqa: E402
from repro.core import SizeyConfig as JConfig  # noqa: E402
from repro.core.temporal.predictor import \
    BOUNDARY_COUNTS as J_BOUNDARY_COUNTS  # noqa: E402
from repro.core.temporal.predictor import \
    TemporalSizeyPredictor as JTemporal  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro.workflow import simulate as j_simulate  # noqa: E402
from repro.workflow.trace import TaskInstance as JTask  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.baselines import SizeyMethod, make_method  # noqa: E402
from repro_torch.core import SizeyConfig  # noqa: E402
from repro_torch.core.predictor import (DISPATCH_COUNTS,  # noqa: E402
                                        SizeyPredictor)
from repro_torch.core.temporal.predictor import (  # noqa: E402
    BOUNDARY_COUNTS, TemporalSizeyPredictor)
from repro_torch.workflow import generate_workflow, simulate  # noqa: E402
from repro_torch.workflow.trace import TaskInstance  # noqa: E402

# The reference's own spread on this replay (tools/port_tolerance.py
# --method sizey_temporal --samples 16 --apart methylation_extract,
# methylseq scale 0.05, on a CPU): 16 one-ulp moves of the MLP's initial
# weights moved an allocation by up to 1.255e-3 outside the pool
# methylation_extract and 1.615e-1 in it, the time-integrated wastage by
# up to 2.991e-4, and no boundary or failure. The large figure is one move
# that flips the HPO learning rate of that 3-task pool (its lr-0.03 loss
# after 300 Adam steps lands on either side of the lr-0.01 loss), whose
# MLP then extrapolates to an input five times its largest; the port
# lands on the same side as that move (tools/port_divergence.py --method
# sizey_temporal). The port is held to twice the spread, that pool to
# twice its own.
ALLOC_RTOL = 2.6e-3
APART = {"methylation_extract": 3.3e-1}
TW_RTOL = 6e-4


def _replay(make, gen, sim, counts, **kw):
    counts.clear()
    method = make("sizey_temporal", **kw)
    decisions = []
    predict_batch = method.predictor.predict_batch

    def recording(tasks):
        out = predict_batch(tasks)
        decisions.extend(out)
        return out

    method.predictor.predict_batch = recording
    res = sim(gen("methylseq", scale=0.05), method)
    return res, decisions, dict(counts)


def test_temporal_replay_matches_reference():
    rj, dj, cj = _replay(j_make, j_generate, j_simulate, J_BOUNDARY_COUNTS)
    rt, dt, ct = _replay(make_method, generate_workflow, simulate,
                         BOUNDARY_COUNTS, device="cpu")
    assert cj == ct and ct["fit"] == 17        # and 27 uniform defaults
    assert len(rj.outcomes) == len(rt.outcomes) == 44
    assert rj.n_failures == rt.n_failures
    assert [o.attempts for o in rj.outcomes] == \
        [o.attempts for o in rt.outcomes]
    assert len(dj) == len(dt)
    n_model = 0
    for a, b in zip(dj, dt):
        assert a.boundaries == b.boundaries
        assert len(a.seg_decisions) == len(b.seg_decisions)
        for x, y in zip(a.seg_decisions, b.seg_decisions):
            assert x.source == y.source
            if x.source == "model":
                n_model += 1
                assert x.offset_idx == y.offset_idx
                assert int(np.argmax(x.raq)) == int(np.argmax(y.raq))
            np.testing.assert_allclose(
                y.allocation_gb, x.allocation_gb,
                rtol=APART.get(x.task_type, ALLOC_RTOL))
    assert n_model > 20
    np.testing.assert_allclose(rt.temporal_wastage_gbh,
                               rj.temporal_wastage_gbh, rtol=TW_RTOL)


def _cfg(**kw):
    kw.setdefault("mlp_train_steps", 30)
    return SizeyConfig(**kw)


def test_temporal_k1_is_the_peak_path_bitwise():
    trace = generate_workflow("iwd", scale=0.05)
    peak = simulate(trace, SizeyMethod(_cfg(), device="cpu"))
    k1 = simulate(trace, SizeyMethod(_cfg(), temporal_k=1, device="cpu"))
    assert SizeyMethod(_cfg(), temporal_k=1, device="cpu").name == "sizey"
    assert len(peak.outcomes) == len(k1.outcomes) > 20
    for a, b in zip(peak.outcomes, k1.outcomes):
        assert a.first_alloc_gb == b.first_alloc_gb
        assert a.final_alloc_gb == b.final_alloc_gb
        assert a.wastage_gbh == b.wastage_gbh
        assert a.tw_gbh == b.tw_gbh
        assert a.attempts == b.attempts


def _curve_task(cls, idx, peak, input_gb):
    return cls("wf", "A", "m", input_gb, peak, 0.5, 64.0, 0, idx,
               usage_curve=((0.4, 0.3 * peak), (0.8, 0.7 * peak),
                            (1.0, peak)))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_temporal_checkpoint_restores_warm_across_packages(tmp_path,
                                                           writer):
    """A checkpoint with ``curve`` aux rows, written by one package, is
    read by the other: same buffers, prequential log and boundaries, and a
    warm plan with the writer's integer choices."""
    path = str(tmp_path / "prov.jsonl")
    rng = np.random.default_rng(2)
    xs = rng.uniform(1, 8, 10)
    if writer == "reference":
        live = JTemporal(JConfig(mlp_train_steps=30), k_segments=3,
                         persist_path=path)
        cls = JTask
    else:
        live = TemporalSizeyPredictor(_cfg(), k_segments=3,
                                      persist_path=path, device="cpu")
        cls = TaskInstance
    for i, x in enumerate(xs):
        t = _curve_task(cls, i, float(2 * x + 1), float(x))
        live.observe(live.predict(t), t, 1)
    probe = _curve_task(cls, 99, 9.0, 4.0)
    want = live.predict(probe)
    if writer == "reference":
        restored = TemporalSizeyPredictor(_cfg(), k_segments=3,
                                          persist_path=path, device="cpu")
        probe = _curve_task(TaskInstance, 99, 9.0, 4.0)
    else:
        restored = JTemporal(JConfig(mlp_train_steps=30), k_segments=3,
                             persist_path=path)
        probe = _curve_task(JTask, 99, 9.0, 4.0)
    a, b = live.db.pool("A", "m"), restored.db.pool("A", "m")
    assert a.count == b.count and a.log_count == b.log_count > 0
    np.testing.assert_array_equal(np.asarray(a.log_agg),
                                  np.asarray(b.log_agg))
    assert len(restored.db.aux["curve"]) == len(xs)
    assert restored.boundaries("A", "m") == live.boundaries("A", "m")
    got = restored.predict(probe)
    assert got.source == want.source == "model"
    assert got.boundaries == want.boundaries
    for x, y in zip(want.seg_decisions, got.seg_decisions):
        assert x.offset_idx == y.offset_idx
        assert int(np.argmax(x.raq)) == int(np.argmax(y.raq))
        # the warm start retrains from the same seed in the other package
        np.testing.assert_allclose(y.allocation_gb, x.allocation_gb,
                                   rtol=1e-4)


def test_sizey_method_temporal_persistence_wiring(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = SizeyMethod(_cfg(), temporal_k=2, persist_path=path, device="cpu")
    assert m.name == "sizey_temporal"
    trace = generate_workflow("iwd", scale=0.03, curve_shapes=("ramp",))
    simulate(trace, m)
    m2 = SizeyMethod(_cfg(), temporal_k=2, persist_path=path, device="cpu")
    t = trace.tasks[0]
    assert m2.allocate(t) > 0
    plan = m2.plan_for(t)
    assert plan is not None and plan.k >= 1
    assert SizeyMethod(_cfg(), device="cpu").plan_for(t) is None


def test_amortized_refit_schedule_bounds_full_retrains():
    """With ``refit_growth = r`` a pool fully retrains only once its
    history grew by the fraction r since the last fit (or its buffers
    grew); every other completion costs one refresh. The dispatch counters
    replay that schedule exactly, sublinear in n (the reference's test of
    the same name, on the port)."""
    cfg = _cfg(refit_growth=0.5)
    p = SizeyPredictor(cfg, device="cpu")
    rng = np.random.default_rng(0)
    n = 40
    exp_fits = exp_refreshes = 0
    fitted, fit_cap, next_fit = False, None, 0
    with obs.scoped_counters(DISPATCH_COUNTS) as dc:
        for x in rng.uniform(1, 8, n):
            d = p.predict("t", "m", (float(x),), 32.0)
            p.observe(d, float(2 * x + 1), 1.0, 1)
            pool = p.db.pool("t", "m")
            if pool.count < cfg.min_history:
                continue
            if not fitted or fit_cap != pool.cap or pool.count >= next_fit:
                exp_fits += 1
                fitted, fit_cap = True, pool.cap
                next_fit = pool.count + max(
                    1, math.ceil(cfg.refit_growth * pool.count))
            else:
                exp_refreshes += 1
        fits = dc["observe_pool"]
        refreshes = dc["refresh_pool"]
    assert fits == exp_fits
    assert refreshes == exp_refreshes
    assert fits + refreshes == n - (cfg.min_history - 1)
    assert fits < refreshes


def test_boundary_cache_one_fit_per_pool_generation():
    """Retries and same-wave siblings hit the generation-keyed boundary
    cache; only an observed completion triggers a refit (the reference's
    test of the same name, on the port)."""
    p = TemporalSizeyPredictor(_cfg(), k_segments=3, device="cpu")
    for i in range(4):
        t = _curve_task(TaskInstance, i, 4.0 + i, 1.0 + i)
        p.observe(p.predict(t), t, 1)
    with obs.scoped_counters(BOUNDARY_COUNTS) as bc:
        b1 = p.boundaries("A", "m")          # stale after the observes
        assert bc["fit"] == 1
        assert p.boundaries("A", "m") == b1  # retry of the same attempt
        assert bc["fit"] == 1 and bc["hit"] == 1
        wave = [_curve_task(TaskInstance, 10 + i, 6.0, 2.0)
                for i in range(3)]
        ds = p.predict_batch(wave)
        assert all(d.boundaries == b1 for d in ds)
        assert bc["fit"] == 1 and bc["hit"] == 4
        p.observe_batch([(ds[0], wave[0], 1)])
        p.boundaries("A", "m")
        p.boundaries("A", "m")
        assert bc["fit"] == 2


def test_warm_start_rebuilds_boundary_cache(tmp_path):
    path = str(tmp_path / "prov.jsonl")
    p = TemporalSizeyPredictor(_cfg(), k_segments=3, persist_path=path,
                               device="cpu")
    for i in range(5):
        t = _curve_task(TaskInstance, i, 3.0 + i, 1.0 + 0.5 * i)
        p.observe(p.predict(t), t, 1)
    b_live = p.boundaries("A", "m")
    p2 = TemporalSizeyPredictor(_cfg(), k_segments=3, persist_path=path,
                                device="cpu")
    with obs.scoped_counters(BOUNDARY_COUNTS) as bc:
        assert p2.boundaries("A", "m") == b_live
        assert bc["fit"] == 0 and bc["hit"] == 1
