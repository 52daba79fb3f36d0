"""Dynamic prediction offset (paper §II-E), in torch.

Four candidate offsets come from the history of aggregate prediction
errors e_j = y_j - y_hat_j (positive e = underprediction): the std of all
errors, the std of underpredictions, the median absolute error and the
median underprediction. Each is scaled by ``OFFSET_MULTIPLIERS`` and the
candidate that would have wasted least on the already executed tasks is
chosen (see ``repro.core.offsets`` for the replay's cost model).
"""
from __future__ import annotations

import torch

from repro_torch.utils.misc import device_constant

OFFSET_STRATEGIES = ("std", "std_under", "median_err", "median_err_under")
OFFSET_MULTIPLIERS = (1.0, 1.5, 2.0, 3.0)

_EPS = 1e-9


def _masked_std(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum().clamp_min(1.0)
    mean = (x * mask).sum() / n
    var = (((x - mean) ** 2) * mask).sum() / n
    return var.clamp_min(0.0).sqrt()


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of the masked entries (0 if none): the mean of the two
    middle values for an even count, as the reference computes it."""
    n = mask.sum().to(torch.int64)
    s = torch.where(mask > 0, x, torch.inf).sort().values
    lo = ((n - 1) // 2).clamp_min(0)
    hi = (n // 2).clamp_min(0)
    # torch.take: indexing with a 0-d tensor would read it on the host
    med = 0.5 * (torch.take(s, lo) + torch.take(s, hi))
    return torch.where(n > 0, med, torch.zeros_like(med))


def candidate_offsets(errors: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """The 4 candidate offsets, in ``OFFSET_STRATEGIES`` order."""
    under = mask * (errors > 0)
    offs = torch.stack([_masked_std(errors, mask),
                        _masked_std(errors, under),
                        _masked_median(errors.abs(), mask),
                        _masked_median(errors, under)])
    return offs.clamp_min(0.0)  # an offset never reduces the allocation


def retrospective_wastage(offset, preds, actuals, runtimes, mask, max_seen,
                          ttf: float = 1.0) -> torch.Tensor:
    """Wastage (GBh) history would have incurred with ``offset`` added,
    summed over the trailing (history) axis: a success wastes
    (alloc - actual) * runtime; a failure burns alloc for ttf * runtime
    and then wastes (max_seen - actual) * runtime on the retry."""
    alloc = preds + offset
    ok = alloc >= actuals
    waste_ok = (alloc - actuals) * runtimes
    waste_fail = alloc * (ttf * runtimes) \
        + (max_seen - actuals).clamp_min(0.0) * runtimes
    return (torch.where(ok, waste_ok, waste_fail) * mask).sum(-1)


def select_offset(errors, preds, actuals, runtimes, mask,
                  ttf: float = 1.0):
    """Pick the least-retrospective-wastage candidate (paper §II-E).

    Returns (offset_value, strategy index into OFFSET_STRATEGIES), both
    0-d tensors; the first minimum wins a tie."""
    offs = candidate_offsets(errors, mask)
    mults = device_constant(OFFSET_MULTIPLIERS, offs.device)
    flat = (offs[:, None] * mults[None, :]).reshape(-1)
    max_seen = torch.where(mask > 0, actuals,
                           torch.zeros_like(actuals)).max()
    wastes = retrospective_wastage(flat[:, None], preds[None, :],
                                   actuals[None, :], runtimes[None, :],
                                   mask[None, :], max_seen, ttf)
    idx = wastes.argmin()
    return torch.take(flat, idx), idx // len(OFFSET_MULTIPLIERS)
