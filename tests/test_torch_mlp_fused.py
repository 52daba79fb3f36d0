"""The fused MLP predict (``kernels/ensemble_mlp``'s ``mlp_predict``, one
launch for the MLP model's whole ``predict_batch``) on the CPU, where it
runs its plain version: bitwise the four eager steps around the forward
that the model took before, and within PRED_RTOL["mlp"] = 1e-5 of the JAX
reference's ``core/models/mlp.py::predict_batch`` (the tolerance of
tests/test_torch_models.py: fp32 sums over d and h in another order), on
states and features made with numpy from a seed. The kernel itself is held
against this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.models import mlp as j_mlp  # noqa: E402
from repro_torch.core.models import mlp  # noqa: E402
from repro_torch.kernels import KERNEL_LAUNCHES  # noqa: E402
from repro_torch.kernels.ensemble_mlp.ops import (ensemble_mlp_forward,  # noqa: E402
                                                  mlp_predict)
from repro_torch.kernels.ensemble_mlp.ref import mlp_predict_ref  # noqa: E402

PRED_RTOL = 1e-5
# (T, d) of the replays' predicts and refreshes, and ragged ones
SHAPES = [(1, 1), (128, 1), (256, 1), (4, 2), (512, 2), (7, 3), (33, 4)]


def _state(t, d, h, seed):
    """Weights, statistics and features as the model holds them: features
    of task sizes (tens of GB), standardised by the statistics."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0, lo=0.0: (lo + rng.standard_normal(s) * sc
                                    ).astype(np.float32)
    w1, b1 = f(d, h, sc=0.5), f(h, sc=0.1)
    w2, b2 = f(h, 1, sc=0.5), f(1, sc=0.1)
    mu_x = rng.uniform(10.0, 30.0, d).astype(np.float32)
    sd_x = rng.uniform(1.0, 8.0, d).astype(np.float32)
    mu_y = np.float32(rng.uniform(1.0, 50.0))
    sd_y = np.float32(rng.uniform(0.5, 20.0))
    x = f(t, d, sc=5.0, lo=20.0)
    return x, (w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y)


def _torch_state(arrays):
    w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y = (torch.from_numpy(np.asarray(a))
                                              for a in arrays)
    return mlp.MLPState(w1, b1, w2, b2, (), (), torch.zeros(()), mu_x, sd_x,
                        mu_y, sd_y, torch.zeros(()))


def _four_steps(state, xq):
    """The model's predict as it was before the fused entry: normalise,
    the ensemble forward of one model, de-normalise."""
    xn = ((xq - state.mu_x) / state.sd_x).contiguous()
    yn = ensemble_mlp_forward(xn[None], state.w1[None], state.b1[None],
                              state.w2[None], state.b2[None])[0]
    return yn * state.sd_y + state.mu_y


@pytest.mark.parametrize("t,d", SHAPES)
def test_fused_plain_version_is_bitwise_the_four_step_path(t, d):
    torch.set_num_threads(1)
    x, arrays = _state(t, d, 32, seed=t * 10 + d)
    state, xq = _torch_state(arrays), torch.from_numpy(x)
    want = _four_steps(state, xq)
    before = dict(KERNEL_LAUNCHES)
    got = mlp.predict_batch(state, xq)
    assert dict(KERNEL_LAUNCHES) == before   # the CPU launches nothing
    assert got.shape == (t,) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(mlp_predict_ref(xq, *state[:4], *state[7:11]), want)


@pytest.mark.parametrize("t,d", SHAPES)
def test_fused_predict_matches_the_reference_predict_batch(t, d):
    torch.set_num_threads(1)
    x, arrays = _state(t, d, 32, seed=100 + t * 10 + d)
    w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y = (jnp.asarray(a) for a in arrays)
    zeros = (jnp.zeros(()),) * 4
    jstate = j_mlp.MLPState(w1, b1, w2, b2, zeros, zeros, jnp.zeros(()),
                            mu_x, sd_x, mu_y, sd_y, jnp.zeros(()))
    want = np.asarray(j_mlp.predict_batch(jstate, jnp.asarray(x)))
    got = mlp.predict_batch(_torch_state(arrays), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=PRED_RTOL, atol=1e-5)


def test_fused_predict_refuses_what_it_does_not_take():
    x, arrays = _state(5, 2, 8, seed=1)
    args = [torch.from_numpy(np.asarray(a)) for a in arrays]
    xq = torch.from_numpy(x)
    with pytest.raises(ValueError):          # mu_x of the wrong width
        mlp_predict(xq, *args[:4], args[4][:1], *args[5:])
    with pytest.raises(ValueError):          # x is not (T, d)
        mlp_predict(xq[None], *args)
    meta = [a.to("meta") for a in [xq, *args]]
    with pytest.raises(ValueError):          # no kernel for this device
        mlp_predict(*meta)
