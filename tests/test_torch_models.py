"""The port's four models against the reference's, on the same buffers.

Fit from the same seed (the port reproduces the reference's draws), update
from a state carried across with repro_torch.convert, and predict from a
carried-across state. Inputs are made with numpy from fixed seeds; the
reference runs its plain jnp paths under jit, as its predictor does.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the port runs thousands of tiny ops per replay: one intra-op thread per
# test process (the suite runs several) is faster than a spinning pool
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core.config import SizeyConfig  # noqa: E402
from repro.core.models import MODEL_MODULES as J  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.models import MODEL_MODULES as P  # noqa: E402

CFG = SizeyConfig()
SEED = 20240917
FUNCS = {
    "line": lambda x: 3.0 * x + 2.0,
    "quadratic": lambda x: 0.5 * x * x + 1.0,
    "step": lambda x: 8.0 if x > 4.0 else 2.0,
}


def _buffers(fn, n=64, cap=128, d=1, seed=0):
    rng = np.random.default_rng(seed)
    xs = np.zeros((cap, d), np.float32)
    ys = np.zeros((cap,), np.float32)
    xs[:n] = rng.uniform(0.1, 8.0, (n, d))
    ys[:n] = [fn(x) + 0.1 * rng.standard_normal() for x in xs[:n, 0]]
    mask = np.zeros((cap,), np.float32)
    mask[:n] = 1.0
    return xs, ys, mask


_JITTED = {}


def _jit(kind, model):
    """One compiled reference function per (kind, model), as the
    reference's predictor caches them; the key is built from a traced
    seed there too."""
    if (kind, model) not in _JITTED:
        if kind == "fit":
            fn = lambda a, b, m, s: J[model].fit(a, b, m,
                                                 jax.random.PRNGKey(s), CFG)
        else:
            fn = lambda st, a, b, m, i, s: J[model].update(
                st, a, b, m, i, jax.random.PRNGKey(s), CFG)
        _JITTED[kind, model] = jax.jit(fn)
    return _JITTED[kind, model]


def _jax_fit(model, xs, ys, mask, seed):
    return jax.device_get(_jit("fit", model)(xs, ys, mask, seed))


def _port_fit(model, xs, ys, mask, seed):
    return P[model].fit(torch.from_numpy(xs), torch.from_numpy(ys),
                        torch.from_numpy(mask), prng.prng_key(seed), CFG)


def _jax_predict(model, state, xq):
    state = jax.tree.map(jnp.asarray, state)
    if model == "knn":
        return np.asarray(J[model].predict_batch(state, jnp.asarray(xq),
                                                 k=CFG.knn_k))
    return np.asarray(J[model].predict_batch(state, jnp.asarray(xq)))


def _port_predict(model, state, xq):
    if model == "knn":
        return P[model].predict_batch(state, torch.from_numpy(xq),
                                      k=CFG.knn_k).numpy()
    return P[model].predict_batch(state, torch.from_numpy(xq)).numpy()


# rtol of each model's predictions, port vs reference: linear solves the
# 2x2 normal equations by Cholesky in another order; the MLP sums its
# gradients in another order for 3 x 300 Adam steps (measured < 1e-6 on
# these buffers, the bound leaves a decade); k-NN and forest reduce in
# the same order up to 8-term means
PRED_RTOL = {"linear": 1e-4, "knn": 1e-6, "forest": 1e-6, "mlp": 1e-5}


@pytest.mark.parametrize("model", ["linear", "knn", "forest", "mlp"])
@pytest.mark.parametrize("func", ["line", "quadratic", "step"])
def test_fit_from_the_same_seed(model, func):
    xs, ys, mask = _buffers(FUNCS[func], n=64, seed=len(func))
    js = _jax_fit(model, xs, ys, mask, SEED)
    ts = _port_fit(model, xs, ys, mask, SEED)
    xq = np.linspace(0.0, 9.0, 37, dtype=np.float32)[:, None]
    np.testing.assert_allclose(_port_predict(model, ts, xq),
                               _jax_predict(model, js, xq),
                               rtol=PRED_RTOL[model], atol=1e-5)
    if model == "forest":   # the split choices are integers: equal
        np.testing.assert_array_equal(ts.feat.numpy(), js.feat)
        np.testing.assert_array_equal(ts.thresh.numpy(), js.thresh)
    if model == "mlp":      # the HPO choice is an integer: equal
        assert float(ts.lr) == float(js.lr)


def test_forest_two_features_picks_the_same_splits():
    rng = np.random.default_rng(3)
    xs, ys, mask = _buffers(lambda x: 1.0, n=90, d=2, seed=4)
    ys[:90] = np.where(xs[:90, 1] > 5.0, 9.0, 1.0) + 0.3 * xs[:90, 0] \
        + 0.05 * rng.standard_normal(90)
    js = _jax_fit("forest", xs, ys, mask, 77)
    ts = _port_fit("forest", xs, ys, mask, 77)
    np.testing.assert_array_equal(ts.feat.numpy(), js.feat)
    np.testing.assert_array_equal(ts.thresh.numpy(), js.thresh)
    np.testing.assert_allclose(ts.leaf_vals.numpy(), js.leaf_vals,
                               rtol=1e-6)


@pytest.mark.parametrize("model", ["linear", "knn", "forest", "mlp"])
def test_update_from_a_carried_across_state(model):
    xs, ys, mask = _buffers(FUNCS["quadratic"], n=40, seed=9)
    js = _jax_fit(model, xs, ys, mask, SEED)
    ts = convert.state_to_torch(model, js, "cpu")
    # one more observation arrives in slot 40
    xs[40, 0], ys[40], mask[40] = 3.3, FUNCS["quadratic"](3.3), 1.0
    j_up = jax.device_get(_jit("update", model)(js, xs, ys, mask, 40, 5))
    t_up = P[model].update(ts, torch.from_numpy(xs), torch.from_numpy(ys),
                           torch.from_numpy(mask), 40, prng.prng_key(5), CFG)
    xq = np.linspace(0.0, 9.0, 19, dtype=np.float32)[:, None]
    np.testing.assert_allclose(_port_predict(model, t_up, xq),
                               _jax_predict(model, j_up, xq),
                               rtol=PRED_RTOL[model], atol=1e-5)


@pytest.mark.parametrize("model", ["linear", "knn", "forest", "mlp"])
def test_predict_from_a_carried_across_state(model):
    xs, ys, mask = _buffers(FUNCS["step"], n=70, seed=2)
    js = _jax_fit(model, xs, ys, mask, 11)
    ts = convert.state_to_torch(model, js, "cpu")
    xq = np.random.default_rng(1).uniform(0, 9, (64, 1)).astype(np.float32)
    # the same state: only the forward's arithmetic may differ (the MLP's
    # 32-term sum and tanh; the ridge's 2-term dot)
    np.testing.assert_allclose(_port_predict(model, ts, xq),
                               _jax_predict(model, js, xq),
                               rtol=1e-6, atol=1e-6)
    back = convert.state_to_numpy(model, ts)
    for a, b in zip(jax.tree.leaves(tuple(js)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype


def test_tiny_history_is_finite_for_every_model():
    xs, ys, mask = _buffers(lambda x: x + 1.0, n=3)
    for model in P:
        out = _port_predict(model, _port_fit(model, xs, ys, mask, 1),
                            np.asarray([[0.5], [4.0]], np.float32))
        assert np.all(np.isfinite(out)), model


def test_ridge_solve_routes_against_the_reference():
    """The ridge weights from the reference's own normal equations. The
    reference solves on the Cholesky factor with two general solves (an
    LU route); ``solve_ex`` on the same factors takes that route on the
    CPU and gives the reference's weights bit for bit on some systems,
    where the port's two triangular solves give them on none; both stay
    within a few 1e-6 of the reference's predictions. The port keeps the
    triangular solves: with the LU route the linear model's predictions
    in test_torch_predictor.py's streams move closer to the reference's,
    but a near-tied offset choice there flips. What differs besides is
    X'y: XLA sums the CPU mat-vec product in vector lanes. Inputs are 1-
    and 2-feature buffers (the peak and temporal paths)."""
    from repro.core.models import linear as jl
    from repro_torch.core.models import linear as tl
    lam = CFG.ridge_lambda
    jsolve = jax.jit(lambda a, b: jl._solve(a, b, lam))

    def lu_route(xtx, xty):
        a = xtx + lam * torch.eye(xtx.shape[0])
        l, _ = torch.linalg.cholesky_ex(a)
        z, _ = torch.linalg.solve_ex(l, xty[:, None], check_errors=False)
        return torch.linalg.solve_ex(l.T, z, check_errors=False)[0][:, 0]

    rng = np.random.default_rng(2)
    equal = {"port": 0, "lu": 0}
    worst = {"port": 0.0, "lu": 0.0}
    for trial in range(60):
        d = 1 + trial % 2
        xs, ys, mask = _buffers(lambda x: 2.0 * x + 1.0, n=int(
            rng.integers(3, 120)), d=d, seed=trial)
        js = _jax_fit("linear", xs, ys, mask, 0)
        xtx, xty = np.asarray(js.xtx), np.asarray(js.xty)
        want = np.asarray(jsolve(xtx, xty))
        np.testing.assert_array_equal(want, js.w)
        # X'X is the reference's bit for bit
        tx = tl._aug(torch.from_numpy(xs)) * torch.from_numpy(mask)[:, None]
        np.testing.assert_array_equal((tx.T @ tx).numpy(), xtx)
        xq = np.concatenate([rng.uniform(0, 9, (8, d)),
                             np.ones((8, 1))], 1).astype(np.float32)
        for name, got in (
                ("port", tl._solve(torch.from_numpy(xtx.copy()),
                                   torch.from_numpy(xty.copy()), lam)),
                ("lu", lu_route(torch.from_numpy(xtx.copy()),
                                torch.from_numpy(xty.copy())))):
            got = got.numpy()
            equal[name] += int(np.array_equal(got, want))
            worst[name] = max(worst[name], float(np.max(
                np.abs(xq @ got - xq @ want) / np.abs(xq @ want))))
    assert equal["port"] == 0 < equal["lu"]
    assert worst["lu"] < worst["port"] < 1e-5
