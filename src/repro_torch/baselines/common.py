"""Shared history bookkeeping for the baselines."""
from __future__ import annotations

import numpy as np

from repro_torch.workflow.accounting import (DEFAULT_CHECKPOINT_FRAC,
                                       FAILURE_STRATEGIES, doubling_retry)
from repro_torch.workflow.trace import TaskInstance


class HistoryMethod:
    """Per-(task_type, machine) observation history + doubling retry.

    ``failure_strategy`` is the Ponder-style crash handling the cluster
    engine applies to the method's attempts (``retry_same`` is the
    pre-strategy semantics; ``retry_scaled`` re-sizes interrupted tasks
    through ``allocate`` before re-dispatch; ``checkpoint`` resumes from
    the last checkpoint). Baselines carry the attribute so every sizing
    method competes under every strategy; only Sizey's crash-aware
    configuration additionally changes its *allocations* on crashes.
    """

    name = "history"
    min_history = 3
    failure_strategy = "retry_same"
    checkpoint_frac = DEFAULT_CHECKPOINT_FRAC

    def __init__(self, machine_cap_gb: float = 128.0, *,
                 failure_strategy: str | None = None):
        if failure_strategy is not None:
            if failure_strategy not in FAILURE_STRATEGIES:
                raise ValueError(
                    f"unknown failure strategy {failure_strategy!r} "
                    f"(have {FAILURE_STRATEGIES})")
            self.failure_strategy = failure_strategy
        self.machine_cap_gb = machine_cap_gb
        self.n_interruptions = 0       # crash kills observed (engine hook)
        self._xs: dict[tuple[str, str], list[float]] = {}
        self._ys: dict[tuple[str, str], list[float]] = {}
        self._rts: dict[tuple[str, str], list[float]] = {}

    def note_interruption(self, task: TaskInstance,
                          elapsed_h: float) -> None:
        """Cluster-engine hook: a crash/preemption killed one attempt."""
        self.n_interruptions += 1

    def _key(self, task: TaskInstance) -> tuple[str, str]:
        return (task.task_type, task.machine)

    def cap_for(self, task: TaskInstance) -> float:
        """Capacity to clamp against: the task's own machine-class cap on a
        heterogeneous trace, the method-wide machine cap otherwise."""
        cap = task.machine_cap_gb
        return self.machine_cap_gb if cap is None else float(cap)

    def history(self, task: TaskInstance):
        k = self._key(task)
        return (np.asarray(self._xs.get(k, [])),
                np.asarray(self._ys.get(k, [])),
                np.asarray(self._rts.get(k, [])))

    # SizingMethod protocol -------------------------------------------------
    def allocate(self, task: TaskInstance) -> float:
        raise NotImplementedError

    def retry(self, task: TaskInstance, attempt: int,
              last_alloc_gb: float) -> float:
        return doubling_retry(last_alloc_gb, self.cap_for(task))

    def complete(self, task: TaskInstance, first_alloc_gb: float,
                 attempts: int) -> None:
        k = self._key(task)
        self._xs.setdefault(k, []).append(task.input_size_gb)
        self._ys.setdefault(k, []).append(task.actual_peak_gb)
        self._rts.setdefault(k, []).append(task.runtime_h)
