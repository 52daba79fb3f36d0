"""The port's segment-boundary DP (K3's plain version and the boundary fit
around it) against the reference, on the CPU.

  * the plain PyTorch version gives the cost matrix and the cut indices of
    the reference's numpy oracle (``repro.kernels.segment_dp.ref``) bit
    for bit, over the profile kinds and the M, G, k that ``chip_smoke.py``
    holds the CUDA kernel to;
  * it gives the cuts of the reference's jitted ``fit_cuts`` too, except
    where XLA contracts the reference's multiply and subtract into one
    fused multiply-add, which its own oracle does not: each such case is
    shown to be that contraction;
  * ``fit_boundaries`` and the segment helpers equal the reference's.
"""
import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.temporal import segments as jseg  # noqa: E402
from repro.kernels.segment_dp import ops as jops  # noqa: E402
from repro.kernels.segment_dp import ref as jref  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro_torch.core.temporal import segments as tseg  # noqa: E402
from repro_torch.kernels import KERNEL_LAUNCHES  # noqa: E402
from repro_torch.kernels.segment_dp import ops as tops  # noqa: E402
from repro_torch.kernels.segment_dp import ref as tref  # noqa: E402

# the maker, the profile kinds and the shapes chip_smoke.py holds the
# kernel to: the main path's G = 32 and k = 4, M from a young pool to
# PROFILE_WINDOW = 512, and edges of G
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import K3_GS as GS  # noqa: E402
from chip_smoke import K3_KINDS as KINDS  # noqa: E402
from chip_smoke import K3_MS as MS  # noqa: E402
from chip_smoke import k3_profiles as profiles  # noqa: E402


def contracted_cost(P: np.ndarray) -> np.ndarray:
    """The reference's cost with ``rmax * width - csum`` rounded once, as a
    fused multiply-add does (the product of two float32 is exact in
    float64)."""
    m, g = P.shape
    cost = np.full((g + 1, g + 1), np.inf, np.float32)
    widths = np.arange(1, g + 1, dtype=np.float64)
    for i in range(g):
        tail = P[:, i:]
        rmax = np.maximum.accumulate(tail, axis=1).astype(np.float64)
        csum = np.cumsum(tail, axis=1, dtype=np.float32).astype(np.float64)
        val = (rmax * widths[None, :g - i] - csum).astype(np.float32)
        colsum = np.zeros(g - i, np.float32)
        for row in val:
            colsum += row
        cost[i, i + 1:] = colsum
    return cost


def dp_cuts(cost: np.ndarray, k: int) -> np.ndarray:
    """The reference oracle's DP and backtrack on a given cost matrix."""
    g = cost.shape[0] - 1
    dp = np.full(g + 1, np.inf, np.float32)
    dp[0] = 0.0
    back = []
    for _ in range(k):
        cand = dp[:, None] + cost
        back.append(np.argmin(cand, axis=0))
        dp = cand[back[-1], np.arange(g + 1)]
    cuts, j = [], g
    for b in reversed(back):
        cuts.append(j)
        j = int(b[j])
    return np.asarray(cuts[::-1])


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_is_the_reference_oracle_bitwise(kind, m, g):
    P = profiles(kind, m, g, seed=m * 100 + g)
    tP = torch.from_numpy(P)
    want_cost = jref.cost_matrix_ref(P)
    np.testing.assert_array_equal(tref.cost_matrix_ref(P), want_cost)
    np.testing.assert_array_equal(tref.cost_matrix_plain(tP).numpy(),
                                  want_cost)
    for k in sorted({1, 2, 4, g}):
        want = jref.fit_cuts_ref(P, k)
        np.testing.assert_array_equal(tref.fit_cuts_ref(P, k), want)
        got = tref.fit_cuts_plain(tP, k)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{kind} M={m} G={g} k={k}")
        jitted = jops.fit_cuts(P, k)
        if not np.array_equal(jitted, want):
            # the reference's jitted path departs from its own oracle only
            # through XLA's fused multiply-add
            np.testing.assert_array_equal(dp_cuts(contracted_cost(P), k),
                                          jitted)


def test_reference_jit_contracts_multiply_subtract_on_step_profiles():
    """Why the port holds to the reference's numpy oracle and not to its
    jitted path: under jit on the CPU, XLA computes ``rmax * width - csum``
    as one fused multiply-add, so the jitted cost matrix is the contracted
    one, and on step profiles that moves cut indices. The port's plain
    version (and the CUDA kernel, with ``_rn`` intrinsics) rounds twice,
    as the oracle does."""
    import jax
    import jax.numpy as jnp
    jit_cost = jax.jit(jops.cost_matrix_jnp)
    moved = 0
    for seed in range(40):
        P = profiles("step", 1 + seed % 5, 32, seed)
        contracted = contracted_cost(P)
        np.testing.assert_array_equal(np.asarray(jit_cost(jnp.asarray(P))),
                                      contracted)
        oracle = jref.fit_cuts_ref(P, 4)
        np.testing.assert_array_equal(
            tref.fit_cuts_plain(torch.from_numpy(P), 4).numpy(), oracle)
        jitted = jops.fit_cuts(P, 4)
        np.testing.assert_array_equal(dp_cuts(contracted, 4), jitted)
        moved += not np.array_equal(jitted, oracle)
    assert moved > 0


def test_wrappers_take_the_plain_version_on_the_cpu():
    P = profiles("random", 7, 32, seed=3)
    before = dict(KERNEL_LAUNCHES)
    np.testing.assert_array_equal(
        tops.fit_cuts(torch.from_numpy(P), 4).numpy(),
        jref.fit_cuts_ref(P, 4))
    np.testing.assert_array_equal(
        tops.segment_cost(torch.from_numpy(P)).numpy(),
        jref.cost_matrix_ref(P))
    # float64 input is cast, as the reference casts
    np.testing.assert_array_equal(
        tops.fit_cuts(torch.from_numpy(P.astype(np.float64)), 3).numpy(),
        jref.fit_cuts_ref(P, 3))
    assert dict(KERNEL_LAUNCHES) == before    # no launch on the CPU


@pytest.mark.parametrize("shape,k", [((5,), 1), ((3, 32), 0), ((3, 32), 33),
                                     ((3, tops.MAX_GRID + 1), 2),
                                     ((2, 3, 4), 1)])
def test_wrappers_refuse_what_the_kernel_does_not_take(shape, k):
    P = torch.zeros(shape)
    with pytest.raises(ValueError):
        tops.fit_cuts(P, k)
    if len(shape) != 2 or shape[1] > tops.MAX_GRID:
        with pytest.raises(ValueError):
            tops.segment_cost(P)


def _both_fits(profs, k):
    """The reference's default fit, its numpy oracle's and the port's."""
    return (jseg.fit_boundaries(profs, k),
            jseg.fit_boundaries(profs, k, backend="numpy"),
            tseg.fit_boundaries(profs, k, device="cpu"),
            tseg.fit_boundaries(profs, k, backend="numpy"))


@pytest.mark.parametrize("k", [1, 2, 4, 8, 40])
def test_fit_boundaries_equals_the_reference(k):
    g = 32
    degenerate = (
        np.zeros((4, g)), np.full((6, g), 3.0),
        np.stack([jseg.grid_profile(
            ((0.5, 2.0), (0.5, 5.0), (1.0, 1.0)), g)] * 5),
        profiles("step", 9, g, 5).astype(np.float64),
        profiles("ties", 30, g, 6),
        np.zeros((0, g)),                      # no history: uniform
        profiles("random", 1, g, 7)[0],        # one profile, 1-d
    )
    for profs in degenerate:
        fits = _both_fits(profs, k)
        assert all(f == fits[0] for f in fits), (profs.shape, k, fits)
        assert fits[0][-1] == 1.0
        assert all(b > a for a, b in zip(fits[0], fits[0][1:]))


def test_fit_boundaries_needs_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P = profiles("random", 4, 32, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tseg.fit_boundaries(P, 4)
    with pytest.raises(ValueError, match="backend"):
        tseg.fit_boundaries(P, 4, backend="jax")
    # no history and k = 1 need no fit, so no device
    assert tseg.fit_boundaries(np.zeros((0, 32)), 4) == (0.25, 0.5, 0.75,
                                                         1.0)
    assert tseg.fit_boundaries(P, 1) == (1.0,)


def test_segment_helpers_equal_the_reference():
    assert tseg.PROFILE_WINDOW == jseg.PROFILE_WINDOW
    for k in (1, 3, 4, 7):
        assert tseg.uniform_boundaries(k) == jseg.uniform_boundaries(k)
    trace = j_generate("methylseq", scale=0.1)
    bounds = ((1.0,), (0.25, 0.5, 0.75, 1.0), (0.09375, 0.5625, 1.0),
              (0.3, 0.31, 1.0))
    n = 0
    for t in trace.tasks:
        for g in (8, 32, 33):
            a = jseg.grid_profile(t.usage_curve, g, peak_gb=t.actual_peak_gb)
            b = tseg.grid_profile(t.usage_curve, g, peak_gb=t.actual_peak_gb)
            np.testing.assert_array_equal(a, b)
            for bd in bounds:
                np.testing.assert_array_equal(jseg.segment_peaks(a, bd),
                                              tseg.segment_peaks(b, bd))
            n += bool(t.usage_curve)
    assert n > 0
    # an empty curve is flat at the peak (or zero without one)
    np.testing.assert_array_equal(tseg.grid_profile((), 4, 2.0),
                                  jseg.grid_profile((), 4, 2.0))
    np.testing.assert_array_equal(tseg.grid_profile((), 4),
                                  jseg.grid_profile((), 4))
