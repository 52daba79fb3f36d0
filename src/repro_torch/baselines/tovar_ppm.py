"""Tovar-PPM — Tovar et al., "A job sizing strategy for high-throughput
scientific workflows" (TPDS 2017).

First allocation: the candidate value (drawn from the observed peak values)
minimizing the expected slot cost — successful tasks pay the allocated-
but-unused slot, failures pay the burned attempt plus the conservative
retry at the node maximum. On failure the node's maximum memory is
allocated (their very conservative failure handling; paper Fig. 8c shows
correspondingly few failures).
"""
from __future__ import annotations

import numpy as np

from repro_torch.baselines.common import HistoryMethod
from repro_torch.workflow.trace import TaskInstance


class TovarPPM(HistoryMethod):
    name = "tovar_ppm"

    def __init__(self, machine_cap_gb: float = 128.0, ttf: float = 1.0,
                 **kw):
        super().__init__(machine_cap_gb, **kw)
        self.ttf = ttf

    def allocate(self, task: TaskInstance) -> float:
        _, ys, rts = self.history(task)
        cap = self.cap_for(task)
        if ys.size < self.min_history:
            return min(task.user_preset_gb, cap)
        cands = np.unique(ys)
        mean_rt = float(np.mean(rts))
        best_a, best_cost = float(cands[-1]), np.inf
        for a in cands:
            ok = ys <= a
            cost_ok = np.sum((a - ys[ok])) * mean_rt
            # failed: burn a for ttf*rt, retry at node max wastes (cap - y)
            cost_fail = np.sum(a * self.ttf + (cap - ys[~ok])) \
                * mean_rt
            cost = (cost_ok + cost_fail) / ys.size
            if cost < best_cost:
                best_cost, best_a = cost, float(a)
        return min(best_a, cap)

    def retry(self, task: TaskInstance, attempt: int,
              last_alloc_gb: float) -> float:
        return self.cap_for(task)
