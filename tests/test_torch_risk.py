"""The port's risk-priced sizing against the reference, on the CPU: the
cases of ``tests/test_risk.py`` on the same inputs through both packages.

  * the pricing rule, the conformal band, the ensemble spread, the
    collapse rule and the config's validation are the reference's, bit for
    bit (host arithmetic in both);
  * a pool's residuals are bitwise the reference's on equal logs, the
    port's log read from its device buffers in one float32 copy;
  * a cold ``RiskManager`` is bitwise the paper offset in the port, and
    serial runs price at ``tau_max`` with the reference's risk rows.

The engine's cases (pressure, the temporal path, the journal) are in
``tests/test_torch_risk_engine.py``.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core.risk as J  # noqa: E402
import repro_torch.core.risk as T  # noqa: E402
from repro.baselines import make_method as j_make  # noqa: E402
from repro.baselines.sizey_method import SizeyMethod as JMethod  # noqa: E402
from repro.core.provenance import ProvenanceDB as JDB  # noqa: E402
from repro.obs.risk import read_risk_rows as j_rows  # noqa: E402
from repro.obs.risk import summarize_risk as j_summarize  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro.workflow import simulate as j_simulate  # noqa: E402
from repro_torch.baselines import SizeyMethod, make_method  # noqa: E402
from repro_torch.core.provenance import ProvenanceDB  # noqa: E402
from repro_torch.obs.risk import read_risk_rows, summarize_risk  # noqa: E402
from repro_torch.workflow import generate_workflow, simulate  # noqa: E402
from torch_chaos import assert_risk_rows_match  # noqa: E402

CAP = 64.0
SCALE = 0.3          # the reference's serial calibration runs
# the reference's own spread on its serial inputs under 16 1-ulp moves of
# the MLP's initial weights (tools/port_tolerance.py --workflow eager
# --seed S --machine-cap 64 --scale 0.3 --method sizey_risk --samples 16,
# a CPU): the risk rows' allocations move by up to 3.227e-2 (seed 3) and
# 9.768e-3 (seed 7) of themselves, and 4..15 and 5..21 integer choices
# move; the row count, the failures and every attempt count do not. The
# port is held to twice that spread there
SERIAL_SPREAD = {3: (3.227e-2, 15), 7: (9.768e-3, 21)}
# ------------------------------------------------------------ pure pricing
def _grid():
    return np.linspace(0, 1, 11)


@pytest.mark.parametrize("axis", ["pressure", "crash", "both"])
def test_price_quantile_monotone_in_pressure_and_crash(axis):
    cfgs = J.RiskConfig(), T.RiskConfig()
    args = {"pressure": lambda v: (v, 0.0), "crash": lambda v: (0.0, v),
            "both": lambda v: (v, v)}[axis]
    taus = [[mod.price_quantile(cfg, *args(v)) for v in _grid()]
            for mod, cfg in ((J, cfgs[0]), (T, cfgs[1]))]
    assert taus[1] == taus[0]
    cfg = cfgs[1]
    assert taus[1][0] == cfg.tau_max
    assert all(a >= b for a, b in zip(taus[1], taus[1][1:]))
    assert all(cfg.tau_min <= t <= cfg.tau_max for t in taus[1])
    assert T.price_quantile(cfg, 1.0, 1.0) == cfg.tau_min


@pytest.mark.parametrize("crashes", [0, 3, 6])
def test_crash_probability_edges(crashes):
    args = (crashes, 10.0, 5.0, 7)
    p = T.crash_probability(*args)
    assert p == J.crash_probability(*args)
    if crashes == 0:
        assert p == 0.0
    else:
        assert 0.0 < p < 1.0
        assert T.crash_probability(crashes + 3, 10.0, 5.0, 7) > p


@pytest.mark.parametrize("crash_p, raq, want", [
    (0.0, 0.9, "retry_same"), (0.1, None, "retry_same"),
    (0.1, 0.49, "retry_same"), (0.1, 0.5, "retry_scaled"),
    (0.25, 0.9, "checkpoint")])
def test_select_strategy_thresholds(crash_p, raq, want):
    got = T.select_strategy(T.RiskConfig(), crash_p, raq)
    assert got == want == J.select_strategy(J.RiskConfig(), crash_p, raq)


def test_checkpoint_frac_shrinks_with_crash_rate():
    cfg = T.RiskConfig()
    fr = [T.checkpoint_frac_for(cfg, c) for c in np.linspace(0, 1, 9)]
    assert fr == [J.checkpoint_frac_for(J.RiskConfig(), c)
                  for c in np.linspace(0, 1, 9)]
    assert fr[0] == cfg.max_checkpoint_frac
    assert fr[-1] == cfg.min_checkpoint_frac
    assert all(a >= b for a, b in zip(fr, fr[1:]))


@pytest.mark.parametrize("kw", [
    {"tau_min": 0.9, "tau_max": 0.8}, {"tau_max": 1.0}, {"min_samples": 0},
    {"window": 2, "min_samples": 5},
    {"min_checkpoint_frac": 0.6, "max_checkpoint_frac": 0.5}],
    ids=["tau_order", "tau_max", "min_samples", "window", "checkpoint"])
def test_risk_config_validation(kw):
    for mod in (J, T):
        with pytest.raises(ValueError):
            mod.RiskConfig(**kw)


# ------------------------------------------------------------------- bands
def test_conformal_band_empty_log_is_zero():
    assert T.conformal_band(np.zeros((0,)), 0.9) == 0.0 \
        == J.conformal_band(np.zeros((0,)), 0.9)


@pytest.mark.parametrize("res, tau", [
    ([-3.0, -1.0, 0.5, 2.0, 4.0], 0.9), ([-5.0, -2.0, -0.1], 0.99)],
    ids=["sample", "clamped"])
def test_conformal_band_is_sample_value_and_clamped(res, tau):
    res = np.asarray(res)
    band = T.conformal_band(res, tau)
    assert band == J.conformal_band(res, tau)
    if (res >= 0).any():
        assert band in set(res[res >= 0])
    else:
        assert band == 0.0


@pytest.mark.parametrize("window, want", [(50, 1.0), (None, 10.0)])
def test_conformal_band_rolling_window(window, want):
    res = np.concatenate([np.full(50, 10.0), np.full(50, 1.0)])
    assert T.conformal_band(res, 0.9, window=window) == want \
        == J.conformal_band(res, 0.9, window=window)


@pytest.mark.parametrize("preds", [[2.5, 2.5, 2.5], None, [],
                                   [1.0, 2.0, 4.5]],
                         ids=["agree", "none", "empty", "spread"])
def test_zero_spread_single_surviving_model(preds):
    arr = None if preds is None else np.asarray(preds)
    assert T.ensemble_spread(arr) == J.ensemble_spread(arr)
    if preds is None or len(set(preds)) <= 1:
        assert T.ensemble_spread(arr) == 0.0
    res = np.asarray([0.5, 1.0, 1.5, 2.0, 2.5])

    class _Pool:
        log_count = len(res)
        log_actual = res
        log_agg = np.zeros(len(res))
    got = T.RiskManager(T.RiskConfig(spread_coef=1.0)).band(
        ("t", ""), _Pool(), 0.9, np.asarray([4.0, 4.0]))
    assert got == T.conformal_band(res, 0.9) == J.RiskManager(
        J.RiskConfig(spread_coef=1.0)).band(("t", ""), _Pool(), 0.9,
                                            np.asarray([4.0, 4.0]))


@pytest.mark.parametrize("vals, band, want", [
    ([10.0, 10.4], 1.0, True), ([10.0, 11.0], 1.0, False),
    ([10.0], 1.0, False), ([10.0, 10.4], 0.0, False)],
    ids=["flat", "steep", "k1", "cold"])
def test_collapse_temporal_rule(vals, band, want):
    got = T.RiskManager(T.RiskConfig(k_collapse_frac=0.5)) \
        .collapse_temporal(vals, band_gb=band)
    assert got is want
    assert J.RiskManager(J.RiskConfig(k_collapse_frac=0.5)) \
        .collapse_temporal(vals, band_gb=band) is want


@pytest.mark.parametrize("n", [0, 3, 7, 40])
def test_pool_residuals_bitwise_on_equal_logs(n):
    """The port's log lives in float32 device buffers and the reference's
    in float32 arrays: the float64 residuals, the band and the cache read
    per log length are the same, bit for bit."""
    rng = np.random.default_rng(n)
    preds = rng.uniform(0.5, 9.0, (n, 4)).astype(np.float32)
    aggs = rng.uniform(0.5, 9.0, n).astype(np.float32)
    actuals = (aggs + rng.normal(0, 0.7, n)).astype(np.float32)
    dbs = JDB(), ProvenanceDB(device="cpu")
    for db in dbs:
        for p, a, y in zip(preds, aggs, actuals):
            db.add_log("t", "m", p, float(a), float(y), 1.0)
    jp, tp = (db.pools.get(("t", "m")) for db in dbs)
    if n == 0:
        jp, tp = dbs[0].pool("t", "m"), dbs[1].pool("t", "m")
    rj, rt = J.pool_residuals(jp), T.pool_residuals(tp)
    assert rt.dtype == np.float64 and np.array_equal(rt, rj)
    mj, mt = J.RiskManager(J.RiskConfig(min_samples=3)), \
        T.RiskManager(T.RiskConfig(min_samples=3))
    before = dict(T.RESIDUAL_READS)
    for tau in (0.6, 0.95):
        bj = mj.band(("t", "m"), jp, tau, preds[-1] if n else None)
        bt = mt.band(("t", "m"), tp, tau, preds[-1] if n else None)
        assert bt == bj
    reads = T.RESIDUAL_READS["reads"] - before.get("reads", 0)
    assert reads == (1 if n >= 3 else 0)   # one read per log length


# ------------------------------------------------- method-level invariants
def test_auto_strategy_requires_risk():
    for make in (lambda **k: SizeyMethod(device="cpu", **k), JMethod):
        with pytest.raises(ValueError):
            make(failure_strategy="auto")
        assert make(failure_strategy="auto",
                    risk=True).failure_strategy == "auto"


@pytest.mark.parametrize("name", ["sizey_risk", "sizey_risk_temporal"])
def test_make_method_risk_variants(name):
    m = make_method(name, machine_cap_gb=CAP, device="cpu")
    j = j_make(name, machine_cap_gb=CAP)
    assert m.name == j.name == name
    assert m.risk is not None and m.risk.cfg == T.RiskConfig()
    assert m.temporal == j.temporal == name.endswith("temporal")


def test_restore_state_tolerates_pre_risk_journals():
    m = SizeyMethod(machine_cap_gb=CAP, risk=True, device="cpu")
    j = JMethod(machine_cap_gb=CAP, risk=True)
    for x in (m, j):
        x.note_pressure(0.7)
    state = m.export_state()
    assert state == j.export_state() and state["pressure"] == 0.7
    state.pop("pressure")           # a journal written without it
    m.restore_state(state)
    assert m._pressure == 0.0


@pytest.fixture(scope="module")
def serial_off_and_cold():
    """The reference's serial input through the port without risk and with
    a cold manager, and through the reference with the cold manager."""
    trace = generate_workflow("eager", seed=3, scale=SCALE,
                              machine_cap_gb=CAP)
    cold = dict(min_samples=10 ** 6, window=10 ** 6)
    base = simulate(trace, SizeyMethod(machine_cap_gb=CAP, device="cpu"))
    m = SizeyMethod(machine_cap_gb=CAP, risk=T.RiskConfig(**cold),
                    device="cpu")
    res = simulate(trace, m)
    jm = JMethod(machine_cap_gb=CAP, risk=J.RiskConfig(**cold))
    j_simulate(j_generate("eager", seed=3, scale=SCALE, machine_cap_gb=CAP),
               jm)
    return base, res, read_risk_rows(m.predictor.db), j_rows(
        jm.predictor.db)


def test_cold_pool_falls_back_to_paper_offset_bitwise(serial_off_and_cold):
    base, cold, rows, ref_rows = serial_off_and_cold
    assert rows == ref_rows == []
    assert len(base.outcomes) == len(cold.outcomes)
    for a, b in zip(base.outcomes, cold.outcomes):
        assert a.task.key == b.task.key
        assert a.first_alloc_gb == b.first_alloc_gb
        assert a.wastage_gbh == b.wastage_gbh
    assert cold.wastage_gbh == base.wastage_gbh


# ------------------------------------------------------ serial risk runs
@pytest.fixture(scope="module")
def serial_risk():
    """Both packages' serial risk runs at the reference's two seeds."""
    out = {}
    for seed in (3, 7):
        m = SizeyMethod(machine_cap_gb=CAP, risk=True, device="cpu")
        res = simulate(generate_workflow("eager", seed=seed, scale=SCALE,
                                         machine_cap_gb=CAP), m)
        jm = JMethod(machine_cap_gb=CAP, risk=True)
        jres = j_simulate(j_generate("eager", seed=seed, scale=SCALE,
                                     machine_cap_gb=CAP), jm)
        out[seed] = (m, res, read_risk_rows(m.predictor.db), jres,
                     j_rows(jm.predictor.db))
    return out


def test_serial_pressure_absent_prices_at_tau_max(serial_risk):
    m, _res, rows, _jres, ref_rows = serial_risk[3]
    assert rows, "warm pools should have been repriced"
    assert all(r["pressure"] == 0.0 for r in rows)
    assert all(r["crash_p"] == 0.0 for r in rows)
    assert all(r["tau"] == m.risk.cfg.tau_max for r in rows)
    assert all(r["alloc_gb"] >= r["agg_pred_gb"] for r in rows)
    digest = summarize_risk(rows)
    assert digest["n"] == len(rows)
    assert [r["seq"] for r in rows] == list(range(len(rows)))
    rtol, moves = SERIAL_SPREAD[3]
    assert_risk_rows_match(ref_rows, rows, 2 * rtol, 2 * moves)
    ref = j_summarize(ref_rows)
    assert (digest["tau_min"], digest["tau_max"], digest["n_collapsed"]) \
        == (ref["tau_min"], ref["tau_max"], ref["n_collapsed"])


@pytest.mark.parametrize("seed", [3, 7])
def test_risk_never_undercuts_aggregate_or_exceeds_cap(serial_risk, seed):
    _m, res, rows, jres, ref_rows = serial_risk[seed]
    assert rows
    for r in rows:
        assert r["agg_pred_gb"] <= r["alloc_gb"] <= CAP
        assert r["band_gb"] >= 0.0
    rtol, moves = SERIAL_SPREAD[seed]
    assert_risk_rows_match(ref_rows, rows, 2 * rtol, 2 * moves)
    assert [o.attempts for o in res.outcomes] == \
        [o.attempts for o in jres.outcomes]
    assert res.n_failures == jres.n_failures
