"""Workflow-Presets: the developer's static estimate, always (sanity baseline)."""
from __future__ import annotations

from repro_torch.baselines.common import HistoryMethod
from repro_torch.workflow.trace import TaskInstance


class WorkflowPresets(HistoryMethod):
    name = "workflow_presets"

    def allocate(self, task: TaskInstance) -> float:
        return min(task.user_preset_gb, self.cap_for(task))
