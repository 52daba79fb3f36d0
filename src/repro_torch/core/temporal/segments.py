"""Piecewise-constant memory-over-time math (KS+-style k-segment model),
a copy of ``repro.core.temporal.segments`` with the boundary fit on the
port's segment-DP kernel.

A **usage curve** is the ground-truth memory consumption of one task
execution, ``((end_frac, gb), ...)`` over normalized runtime, carried on
``TaskInstance.usage_curve``; an empty curve means "flat at the peak". A
**reservation plan** (:class:`ReservationPlan`) is what an allocator
reserves over the attempt; a plan with one segment is a constant peak
reservation. The workflow accounting layer depends on both.

Segment boundaries are fit by a change-point sweep
(:func:`fit_boundaries`): usage profiles are sampled onto a fixed grid
(:func:`grid_profile`), the over-reservation of covering grid columns
[i, j) with one max-allocated segment is summed over the pool's profiles,
and a k-step DP picks the boundaries minimising the total. On a CUDA
device the whole fit is one launch of the segment-DP kernel
(:mod:`repro_torch.kernels.segment_dp`); ``backend="numpy"`` runs the
reference's numpy oracle, which the kernel reproduces bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.segment_dp.ops import fit_cuts
from repro_torch.kernels.segment_dp.ref import fit_cuts_ref
from repro_torch.utils.misc import resolve_device

__all__ = ["ReservationPlan", "grid_profile", "fit_boundaries",
           "segment_peaks", "uniform_boundaries", "curve_value_at",
           "curve_integral_frac", "PROFILE_WINDOW"]

_EPS = 1e-9

# shared fit window for profile-driven boundary/segment fits (the temporal
# predictor AND the KS+ baseline): bounds the change-point sweep at
# O(WINDOW * G^2) per refit and the in-memory profile store, however long
# the run — recent history is also what a drifting workload wants fit
PROFILE_WINDOW = 512

Curve = tuple  # ((end_frac, gb), ...) — piecewise-constant step function


def curve_value_at(curve, frac: float) -> float:
    """Value of a piecewise-constant ``((end_frac, gb), ...)`` step function
    at time fraction ``frac`` (segments are left-closed: segment i covers
    [end_{i-1}, end_i))."""
    for end, gb in curve:
        if frac < end - _EPS:
            return float(gb)
    return float(curve[-1][1])


def curve_integral_frac(curve, upto: float = 1.0) -> float:
    """Integral of the step function over [0, upto] in (GB · runtime
    fraction); multiply by ``runtime_h`` for GB·h."""
    total, prev = 0.0, 0.0
    for end, gb in curve:
        hi = min(float(end), upto)
        if hi > prev:
            total += (hi - prev) * float(gb)
            prev = hi
        if prev >= upto:
            break
    return total


def _merged_breakpoints(a, b) -> list[float]:
    pts = {float(e) for e, _ in a} | {float(e) for e, _ in b}
    return sorted(p for p in pts if p > _EPS)


@dataclasses.dataclass(frozen=True)
class ReservationPlan:
    """A piecewise-constant reservation schedule over normalized runtime.

    ``segments`` is ``((end_frac, gb), ...)`` with non-decreasing
    ``end_frac`` and the last entry ending at 1.0. Coincident ends (a
    zero-width segment, e.g. from duplicate breakpoints in a usage curve
    hitting the grid twice) are tolerated at construction — they cover no
    time and :meth:`simplify` drops them — but at least one segment must
    have positive width. ``k == 1`` is a constant reservation — the
    engines run it through the legacy peak path unchanged (no RESIZE
    events), which is what makes resize-disabled runs bitwise-equal to
    peak-based ones.
    """
    segments: tuple[tuple[float, float], ...]

    def __post_init__(self):
        if not self.segments:
            raise ValueError("a plan needs at least one segment")
        prev, width = 0.0, False
        for end, gb in self.segments:
            if end < prev - _EPS:
                raise ValueError(f"decreasing segment end {end}")
            width = width or end > prev + _EPS
            prev = max(prev, end)
        if not width:
            raise ValueError("a plan needs a positive-width segment")
        if abs(prev - 1.0) > 1e-6:
            raise ValueError(f"plan must end at frac 1.0, got {prev}")

    @property
    def k(self) -> int:
        return len(self.segments)

    @property
    def peak_gb(self) -> float:
        return max(gb for _, gb in self.segments)

    @property
    def start_gb(self) -> float:
        return float(self.segments[0][1])

    def value_at(self, frac: float) -> float:
        return curve_value_at(self.segments, frac)

    def integral_frac(self, upto: float = 1.0) -> float:
        """Reserved (GB · runtime fraction) over [0, upto]."""
        return curve_integral_frac(self.segments, upto)

    def gbh(self, runtime_h: float, upto: float = 1.0) -> float:
        return self.integral_frac(upto) * runtime_h

    def first_violation(self, curve) -> float | None:
        """First time fraction where the usage curve exceeds the plan
        (None if the plan covers the curve everywhere). Evaluated exactly
        on the merged breakpoints of the two step functions. An empty
        curve carries no constraint HERE — callers modelling the legacy
        "empty = flat at the peak" trace semantics must pass
        ``((1.0, peak_gb),)`` (the ledger's ``violation_frac`` does)."""
        if not curve:
            return None
        prev = 0.0
        for nxt in _merged_breakpoints(self.segments, curve):
            mid = 0.5 * (prev + nxt)
            if curve_value_at(curve, mid) > self.value_at(mid) + 1e-6:
                return prev
            prev = nxt
        return None

    def covers(self, curve) -> bool:
        return self.first_violation(curve) is None

    def simplify(self) -> "ReservationPlan":
        """Drop zero-width segments and merge adjacent segments with equal
        reservation. Zero-width segments (coincident ends) cover no time
        and would otherwise surface as no-op RESIZE events; a plan whose
        predictions all agree collapses to k=1 and is then executed on the
        legacy peak path — cold pools (flat preset plans) therefore behave
        exactly like the peak-based predictor."""
        out: list[tuple[float, float]] = []
        prev = 0.0
        for end, gb in self.segments:
            if end <= prev + _EPS:
                continue                       # zero width: covers no time
            if out and abs(out[-1][1] - gb) <= 1e-9:
                out[-1] = (end, out[-1][1])
            else:
                out.append((end, gb))
            prev = end
        return ReservationPlan(tuple(out)) if len(out) < self.k else self

    def clamped(self, cap_gb: float, min_gb: float = 0.0) -> "ReservationPlan":
        return ReservationPlan(tuple(
            (end, float(np.clip(gb, min_gb, cap_gb)))
            for end, gb in self.segments))


def grid_profile(curve, n_grid: int, peak_gb: float | None = None
                 ) -> np.ndarray:
    """Sample a usage curve onto ``n_grid`` equal time cells, taking the
    MAX of the curve over each cell (exact for piecewise-constant curves:
    a cell's requirement is the largest step overlapping it). An empty
    curve is flat at ``peak_gb``."""
    out = np.zeros(n_grid, np.float64)
    if not curve:
        out[:] = 0.0 if peak_gb is None else float(peak_gb)
        return out
    prev = 0.0
    for end, gb in curve:
        g0 = int(np.floor(prev * n_grid + 1e-9))
        g1 = int(np.ceil(float(end) * n_grid - 1e-9))
        if g1 > g0:
            out[g0:g1] = np.maximum(out[g0:g1], float(gb))
        prev = float(end)
    return out


def uniform_boundaries(k: int) -> tuple[float, ...]:
    """k equal-width segment end fractions — the no-history default."""
    return tuple((i + 1) / k for i in range(k))


def fit_boundaries(profiles: np.ndarray, k: int, *,
                   backend: str | None = None,
                   device=None) -> tuple[float, ...]:
    """Change-point sweep: fit up to ``k`` segment end fractions to a
    stack of grid-sampled usage profiles.

    ``profiles`` is (M, G): M observed executions sampled on a G-cell grid
    (see :func:`grid_profile`). The cost of covering grid columns [i, j)
    with one segment is the over-reservation a max-allocated segment would
    incur there, summed over all M profiles:

        cost(i, j) = sum_m ( max_{g in [i,j)} P[m,g] * (j - i)
                             - sum_{g in [i,j)} P[m,g] )

    and a k-step dynamic program picks the boundary set minimizing the
    total. Returns end fractions, the last being 1.0; ``k`` is clamped to
    G, and ``k == 1`` returns ``(1.0,)`` without a fit. When the optimum
    places two cuts on the same grid column, the coincident cut is
    dropped — zero-width segments never reach a :class:`ReservationPlan`.

    The fit runs on ``device`` (CUDA unless the caller asks for another),
    through :func:`repro_torch.kernels.segment_dp.fit_cuts`: one upload of
    the profiles and one copy of the k cut indices back. ``backend=
    "numpy"`` runs the reference's numpy oracle instead; both return the
    same cut indices on any input.
    """
    P = np.atleast_2d(np.asarray(profiles, np.float32))
    m, g = P.shape
    if m == 0 or g == 0:
        return uniform_boundaries(max(k, 1))
    k = int(max(1, min(k, g)))
    if k == 1:
        return (1.0,)
    if backend == "numpy":
        cuts = fit_cuts_ref(P, k)
    elif backend is None:
        dev = resolve_device(device)
        cuts = fit_cuts(torch.from_numpy(P).to(dev), k).cpu().numpy()
    else:
        raise ValueError(f"unknown backend {backend!r} (None or 'numpy')")
    out: list[float] = []
    for c in cuts:
        frac = float(c) / g
        if not out or frac > out[-1] + _EPS:   # drop coincident cuts
            out.append(frac)
    return tuple(out)


def segment_peaks(profile: np.ndarray, boundaries: tuple[float, ...]
                  ) -> np.ndarray:
    """Per-segment max of one grid profile under the given end fractions.

    Exact when the boundaries lie on grid lines (which
    :func:`fit_boundaries` guarantees): the segment peak is the max of the
    cells it covers. Empty cell ranges (sub-cell segments) fall back to
    the nearest cell.
    """
    g = profile.shape[0]
    out = np.empty(len(boundaries), np.float64)
    lo = 0
    for i, end in enumerate(boundaries):
        hi = min(g, max(lo + 1, int(np.ceil(end * g - 1e-9))))
        out[i] = float(np.max(profile[lo:hi]))
        lo = hi
    return out
