"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernels in interpret mode (as tests/test_kernels.py does) and
its jnp oracles. Inputs are made with numpy from fixed seeds and fed to
both. The CUDA kernels themselves are held against the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the port runs thousands of tiny ops per replay: one intra-op thread per
# test process (the suite runs several) is faster than a spinning pool
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ensemble_mlp.ops import ensemble_mlp_forward as j_mlp  # noqa: E402
from repro.kernels.ensemble_mlp.ref import ensemble_mlp_ref as j_mlp_ref  # noqa: E402
from repro.kernels.knn.ops import knn_predict as j_knn  # noqa: E402
from repro.kernels.knn.ops import pairwise_sq_dists as j_dists  # noqa: E402
from repro.kernels.knn.ref import knn_predict_ref as j_knn_ref  # noqa: E402
from repro_torch.kernels import KERNEL_LAUNCHES  # noqa: E402
from repro_torch.kernels.ensemble_mlp.ops import ensemble_mlp_forward  # noqa: E402
from repro_torch.kernels.knn.ops import knn_predict, pairwise_sq_dists  # noqa: E402
from repro_torch.kernels.knn.ref import nearest_ref  # noqa: E402

T = torch.from_numpy


def _mlp_inputs(m, t, d, h, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return (f(m, t, d), f(m, d, h, sc=0.5), f(m, h, sc=0.1),
            f(m, h, 1, sc=0.5), f(m, 1, sc=0.1))


def _knn_inputs(q, t, d, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        qs = rng.integers(0, 5, (q, d)).astype(np.float32)
        hist = rng.integers(0, 5, (t, d)).astype(np.float32)
    else:
        qs = rng.standard_normal((q, d)).astype(np.float32)
        hist = rng.standard_normal((t, d)).astype(np.float32)
    ys = (rng.standard_normal(t) * 10).astype(np.float32)
    mask = (rng.random(t) > 0.3).astype(np.float32)
    mask[int(t * 0.8):] = 0.0
    return qs, hist, ys, mask


# --------------------------------------------------------- ensemble mlp
# the shapes of tests/test_kernels.py, plus Sizey's main path (M=1, d=1,
# h=32) at ragged task counts
@pytest.mark.parametrize("m,t,d,h", [(4, 64, 1, 32), (2, 200, 3, 16),
                                     (8, 128, 8, 64), (1, 1, 1, 32),
                                     (1, 7, 1, 32), (3, 300, 4, 32)])
def test_ensemble_mlp_plain_matches_reference(m, t, d, h):
    x, w1, b1, w2, b2 = _mlp_inputs(m, t, d, h, seed=m * 1000 + t)
    got = ensemble_mlp_forward(T(x), T(w1), T(b1), T(w2), T(b2)).numpy()
    pallas = np.asarray(j_mlp(x, w1, b1, w2, b2, interpret=True))
    oracle = np.asarray(j_mlp_ref(x, w1, b1, w2, b2))
    # fp32 sums over d and h in another order: the tolerance of
    # tests/test_kernels.py
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=1e-5)


def test_ensemble_mlp_takes_b2_either_shape_and_counts_no_cpu_launch():
    x, w1, b1, w2, b2 = _mlp_inputs(2, 9, 1, 32, seed=3)
    before = dict(KERNEL_LAUNCHES)
    a = ensemble_mlp_forward(T(x), T(w1), T(b1), T(w2), T(b2))
    b = ensemble_mlp_forward(T(x), T(w1), T(b1), T(w2), T(b2[:, 0]))
    assert torch.equal(a, b)
    assert dict(KERNEL_LAUNCHES) == before   # plain version: no launch
    with pytest.raises(ValueError):
        ensemble_mlp_forward(T(x), T(w1), T(b1[:, :5]), T(w2), T(b2))


# ------------------------------------------------------------------ knn
@pytest.mark.parametrize("q,t,d", [(4, 64, 1), (16, 200, 4), (1, 130, 8)])
def test_pairwise_dists_plain_matches_reference(q, t, d):
    qs, hist, _ys, mask = _knn_inputs(q, t, d, seed=q + t)
    got = pairwise_sq_dists(T(qs), T(hist), T(mask)).numpy()
    pallas = np.asarray(j_dists(qs, hist, mask, interpret=True))
    finite = mask > 0
    # the Pallas kernel expands |q-x|^2 = |q|^2 + |x|^2 - 2q.x: the
    # tolerance of tests/test_kernels.py
    np.testing.assert_allclose(got[:, finite], pallas[:, finite],
                               atol=1e-4, rtol=1e-5)
    assert np.all(got[:, ~finite] == np.float32(3.4e38))
    assert np.all(pallas[:, ~finite] > 1e37)


@pytest.mark.parametrize("ties", [False, True])
def test_knn_plain_matches_reference_oracle(ties):
    qs, hist, ys, mask = _knn_inputs(8, 100, 2, seed=11, ties=ties)
    got = knn_predict(T(qs), T(hist), T(ys), T(mask),
                      torch.ones(2), 5).numpy()
    # the reference's oracle takes the same direct differences and
    # jax.lax.top_k; only the order of the 5-term sum may differ
    want = np.asarray(j_knn_ref(qs, hist, ys, mask, k=5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pallas = np.asarray(j_knn(qs, hist, ys, mask, k=5, interpret=True))
    if not ties:   # the expanded distances reorder near-ties
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_stable_top_k_keeps_lax_top_k_order_on_ties():
    rng = np.random.default_rng(5)
    d2 = rng.integers(0, 4, (500, 64)).astype(np.float32)
    _v, idx = jax.lax.top_k(-jnp.asarray(d2), 5)
    _s, got = nearest_ref(T(d2), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(idx))


def test_knn_with_scale_matches_the_model_reference():
    """knn_predict with a per-feature scale is what the reference's k-NN
    model computes (core/models/knn.py::predict_batch)."""
    from repro.core.models import knn as j_model
    qs, hist, ys, mask = _knn_inputs(12, 128, 3, seed=2)
    scale = np.asarray([0.5, 2.0, 1.3], np.float32)
    state = j_model.KNNState(jnp.asarray(hist), jnp.asarray(ys),
                             jnp.asarray(mask), jnp.asarray(scale))
    want = np.asarray(j_model.predict_batch(state, jnp.asarray(qs), k=5))
    got = knn_predict(T(qs), T(hist), T(ys), T(mask), T(scale), 5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_knn_no_valid_row_gives_zero_and_k_above_rows():
    qs, hist, ys, _mask = _knn_inputs(3, 4, 1, seed=1)
    zero = knn_predict(T(qs), T(hist), T(ys), torch.zeros(4),
                       torch.ones(1), 5)
    assert torch.equal(zero, torch.zeros(3))
    all_rows = knn_predict(T(qs), T(hist), T(ys), torch.ones(4),
                           torch.ones(1), 5)
    assert torch.allclose(all_rows, torch.full((3,), float(ys.mean())))


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 2, 1), device="meta")
    with pytest.raises(ValueError):
        ensemble_mlp_forward(x, torch.zeros((1, 1, 4), device="meta"),
                             torch.zeros((1, 4), device="meta"),
                             torch.zeros((1, 4, 1), device="meta"),
                             torch.zeros((1, 1), device="meta"))
    with pytest.raises(ValueError):
        knn_predict(torch.zeros((1, 1), device="meta"),
                    torch.zeros((4, 1), device="meta"),
                    torch.zeros(4, device="meta"),
                    torch.zeros(4, device="meta"),
                    torch.ones(1, device="meta"), 5)
