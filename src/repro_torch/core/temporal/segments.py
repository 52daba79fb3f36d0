"""Piecewise-constant memory-over-time math: usage curves and reservation
plans (a copy of the numpy part of ``repro.core.temporal.segments``).

A **usage curve** is the ground-truth memory consumption of one task
execution, ``((end_frac, gb), ...)`` over normalized runtime, carried on
``TaskInstance.usage_curve``; an empty curve means "flat at the peak". A
**reservation plan** (:class:`ReservationPlan`) is what an allocator
reserves over the attempt; a plan with one segment is a constant peak
reservation. The workflow accounting layer depends on both. The boundary
fit (``fit_boundaries``) belongs to the temporal slice and is not here.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ReservationPlan", "curve_value_at", "curve_integral_frac"]

_EPS = 1e-9

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
