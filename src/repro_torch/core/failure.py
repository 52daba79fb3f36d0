"""Failure handling (paper §II-E, last paragraph).

If a task fails from underprediction, the first retry allocates the maximum
task memory ever observed for the pool; every further retry doubles the
estimate until the machine's resources are exhausted.
"""
from __future__ import annotations


def retry_allocation(attempt: int, last_alloc_gb: float, max_seen_gb: float,
                     machine_cap_gb: float) -> float:
    """Allocation for retry ``attempt`` (1 = first retry after the failure).

    attempt 1 -> max memory ever observed (if larger than what just failed,
                 else fall through to doubling);
    attempt>1 -> double the previous allocation;
    always capped at the machine capacity.
    """
    if attempt <= 0:
        raise ValueError("retry attempt must be >= 1")
    if attempt == 1 and max_seen_gb > last_alloc_gb:
        return min(max_seen_gb, machine_cap_gb)
    return min(last_alloc_gb * 2.0, machine_cap_gb)
