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


# ------------------------------------------------- the kernel's tiling plan
# kernel.cu builds the cost matrix in tiles of ``mt`` profiles and bands of
# start columns (ops.plan), and picks each DP column's minimum with two warp
# reductions. The CPU cannot run the kernel; these tests hold its plan and
# the order of its arithmetic, emulated in numpy float32, to the oracle.

def _row_start(r, L):
    return r * L - r * (r - 1) // 2


def _row_of(e, L, bw):
    """kernel.cu::row_of in float32: the row of a band's entry e."""
    b = np.float32(2 * L + 1)
    disc = b * b - np.float32(8.0) * np.float32(e)
    r = int((b - np.sqrt(disc)) * np.float32(0.5))
    r = max(0, min(r, bw - 1))
    while r > 0 and _row_start(r, L) > e:
        r -= 1
    while r + 1 < bw and _row_start(r + 1, L) <= e:
        r += 1
    return r


def tiled_cost(P: np.ndarray, plan) -> np.ndarray:
    """The cost matrix in kernel.cu's order: per band, per tile of
    ``plan.mt`` profiles, phase A (each (m, i) walks its row, each value
    rounded as the kernel rounds it) into the tile, then phase B (each
    entry adds the tile's values in m order to its running sum)."""
    m, g = P.shape
    C = np.full((g + 1, g + 1), np.inf, np.float32)
    one = np.float32(1.0)
    for i0, i1, E in plan.bands:
        L, bw, m0 = g - i0, i1 - i0, 0
        while True:
            mc = min(plan.mt, m - m0)
            T = np.full((mc, E), np.nan, np.float32)
            rows = P[m0:m0 + mc]
            for r in range(bw):                    # phase A, over m at once
                i, start = i0 + r, _row_start(r, L)
                rmax = rows[:, i].copy()
                csum = rows[:, i].copy()
                width = one
                T[:, start] = rmax * width - csum
                for s in range(1, g - i):
                    v = rows[:, i + s]
                    rmax = np.maximum(rmax, v)
                    csum = csum + v
                    width = width + one
                    T[:, start + s] = rmax * width - csum
            for e in range(E):                     # phase B
                r = _row_of(e, L, bw)
                i = i0 + r
                j = i + 1 + e - _row_start(r, L)
                acc = np.float32(0.0) if m0 == 0 else C[i, j]
                for ml in range(mc):
                    acc = np.float32(acc + T[ml, e])
                C[i, j] = acc
            m0 += mc
            if m0 >= m:
                break
    return C


def _check_plan(m, g):
    p = tops.plan(m, g)
    assert 1 <= p.mt <= max(m, 1)
    # the tiles [0, mt), [mt, 2 mt), ... cover m = 0..M-1 once each
    assert sum(min(p.mt, m - m0) for m0 in range(0, m, p.mt)) == m
    # the bands cover the start columns 0..G-1 once each, in order, and a
    # band's rows lay its entries (i, j > i) out on [0, E) once each
    assert p.bands[0][0] == 0 and p.bands[-1][1] == g
    for (a0, a1, ea), (b0, _b1, _eb) in zip(p.bands, p.bands[1:]):
        assert a1 == b0
    for i0, i1, e in p.bands:
        assert i1 > i0 and e == sum(g - i for i in range(i0, i1))
        assert e <= p.cap or i1 == i0 + 1
        assert _row_start(i1 - i0, g - i0) == e
    assert sum(e for _, _, e in p.bands) == g * (g + 1) // 2
    # within one block's shared memory, for every k and both entry points
    for k in (1, g):
        assert p.smem_bytes(g, k) <= tops.SMEM_BYTES
    assert p.smem_bytes(g, 1, fit=False) <= tops.SMEM_BYTES
    assert p.cost_in_smem == (g <= 169)
    return p


@pytest.mark.parametrize("g_lo,g_hi", [(1, 256), (257, 512), (513, 768),
                                       (769, 1024)])
def test_plan_covers_each_cost_entry_once_within_a_blocks_shared_memory(
        g_lo, g_hi):
    """For G = 1..1024 and M = 1..600: every M at the edges of the tiles
    (1..3, Mt - 1, Mt, Mt + 1, 2 Mt + 1, 600) and, since the plan's Mt is
    min(M, the largest that fits), every M in between takes one of them."""
    for g in range(g_lo, g_hi + 1):
        full = tops.plan(600, g).mt
        for m in {1, 2, 3, 600} | {x for x in (full - 1, full, full + 1,
                                              2 * full + 1) if 1 <= x <= 600}:
            p = _check_plan(m, g)
            assert p.mt == min(m, full)
            assert p.bands == tops.plan(600, g).bands
        assert (len(tops.plan(600, g).bands) == 1) == (g <= 337)
    tops.plan.cache_clear()


def test_plan_edges_are_the_ones_chip_smoke_checks():
    """chip_smoke.py's K3_EDGES are the plan's edges: Mt = 101 at G = 32,
    the cost matrix in shared memory up to G = 169, one band of start
    columns up to G = 337."""
    from chip_smoke import K3_EDGE_MG
    assert tops.plan(600, 32).mt == 101
    assert tops.plan(3, 169).cost_in_smem and not tops.plan(3, 170).cost_in_smem
    assert len(tops.plan(3, 337).bands) == 1 < len(tops.plan(3, 338).bands)
    assert {(100, 32), (101, 32), (102, 32), (203, 32)} <= set(K3_EDGE_MG)
    assert {(m, g) for g in (169, 170, 337, 338, 1024) for m in (1, 2, 3)} \
        <= set(K3_EDGE_MG)


@pytest.mark.parametrize("g", list(range(1, 65)) + [169, 170, 337, 338,
                                                    1024])
def test_row_of_finds_every_entrys_row(g):
    """kernel.cu's closed-form row of a band entry (phase B) is exact."""
    for i0, i1, e_band in tops.plan(3, g).bands:
        L, bw = g - i0, i1 - i0
        want = np.repeat(np.arange(bw), [L - r for r in range(bw)])
        step = max(1, e_band // 4096)       # G = 1024: every 13th entry
        for e in range(0, e_band, step):
            assert _row_of(e, L, bw) == want[e], (g, i0, e)


@pytest.mark.parametrize("m,g", [(0, 32), (1, 32), (7, 32), (101, 32),
                                 (102, 32), (203, 32), (5, 1), (9, 4),
                                 (4, 33), (3, 170), (1, 338), (2, 339)])
@pytest.mark.parametrize("kind", KINDS)
def test_tiled_build_order_is_the_oracle_bitwise(kind, m, g):
    P = profiles(kind, m, g, seed=m * 100 + g)
    np.testing.assert_array_equal(tiled_cost(P, tops.plan(m, g)),
                                  jref.cost_matrix_ref(P))


def _dp_key(c: np.float32, i: int) -> int:
    """kernel.cu::dp_key: unsigned order is the candidates' order; NaN
    first at row 0 and last elsewhere."""
    if np.isnan(c):
        c = np.float32(-np.inf if i == 0 else np.inf)
    u = int(np.float32(c).view(np.uint32))
    return (~u & 0xffffffff) if u & 0x80000000 else u | 0x80000000


def warp_pick(cand: np.ndarray) -> int:
    """kernel.cu's pick of one DP column: each of 32 lanes keeps its rows'
    smallest key with a strict <, then the smallest key over the lanes and
    the smallest row among the lanes holding it."""
    keys, args = [], []
    for lane in range(32):
        key, arg = 0xffffffff, 0
        for i in range(lane, len(cand), 32):
            c = _dp_key(cand[i], i)
            if c < key:
                key, arg = c, i
        keys.append(key)
        args.append(arg)
    best = min(keys)
    return min(a if k == best else 0xffffffff for k, a in zip(keys, args))


def serial_pick(cand: np.ndarray) -> int:
    """The first design's scan: from row 0, a strict <."""
    best, arg = cand[0], 0
    for i in range(1, len(cand)):
        if cand[i] < best:
            best, arg = cand[i], i
    return arg


@pytest.mark.parametrize("n", [2, 5, 32, 33, 64, 65, 170, 1025])
def test_dp_warp_pick_is_the_first_minimum(n):
    """On ties, on inf and on all-inf columns the warp reduction gives
    np.argmin's (first) index; with NaN candidates, the serial scan's."""
    rng = np.random.default_rng(n)
    inf = np.float32(np.inf)
    cols = [rng.integers(0, 3, n).astype(np.float32) for _ in range(20)]
    cols += [np.full(n, inf), np.full(n, np.float32(2.5))]
    for _ in range(20):
        c = rng.integers(0, 4, n).astype(np.float32)
        c[rng.random(n) < 0.5] = inf
        cols.append(c)
    c = np.full(n, inf)
    c[-1] = 1.0
    cols.append(c)
    for c in cols:
        assert warp_pick(c) == np.argmin(c) == serial_pick(c)
    for _ in range(20):
        c = rng.integers(0, 3, n).astype(np.float32)
        c[rng.random(n) < 0.3] = np.nan
        assert warp_pick(c) == serial_pick(c)
    c = np.full(n, np.float32(1.0))
    c[0] = np.nan
    assert warp_pick(c) == serial_pick(c) == 0
