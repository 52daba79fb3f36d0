"""Temporal memory math: usage curves and reservation plans. The boundary
fit and the temporal predictor come with the temporal slice."""
from repro_torch.core.temporal.segments import ReservationPlan

__all__ = ["ReservationPlan"]
