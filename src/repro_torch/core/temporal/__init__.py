"""Temporal memory subsystem (KS+-style time-segmented prediction), as in
the reference's ``repro.core.temporal``:

  * :mod:`repro_torch.core.temporal.segments` — plan and curve math, grid
    sampling of usage curves, and the change-point fit of k segment
    boundaries (on the segment-DP kernel);
  * :mod:`repro_torch.core.temporal.predictor` —
    :class:`TemporalSizeyPredictor`, which predicts each segment's peak
    with the Sizey ensemble.
"""
from repro_torch.core.temporal.segments import (ReservationPlan,
                                                fit_boundaries, grid_profile,
                                                segment_peaks,
                                                uniform_boundaries)

__all__ = ["ReservationPlan", "fit_boundaries", "grid_profile",
           "segment_peaks", "uniform_boundaries", "TemporalSizeyPredictor"]


def __getattr__(name):
    # lazy, as in the reference: the engines import the plan math without
    # the predictor
    if name == "TemporalSizeyPredictor":
        from repro_torch.core.temporal.predictor import TemporalSizeyPredictor
        return TemporalSizeyPredictor
    raise AttributeError(name)
