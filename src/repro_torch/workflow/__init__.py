"""Workflow substrate: DAGs, synthetic nf-core-calibrated traces (with
memory-over-time usage curves) and the serial online execution simulator
with time-to-failure semantics (paper §III-A). Copies of the reference's
framework-free modules; the cluster engine and its journal come later."""
from repro_torch.workflow.trace import TaskInstance, WorkflowTrace
from repro_torch.workflow.dag import WorkflowDAG
from repro_torch.workflow.accounting import (FAILURE_STRATEGIES, MAX_ATTEMPTS,
                                             AttemptLedger, TaskOutcome)
from repro_torch.workflow.generators import WORKFLOWS, generate_workflow
from repro_torch.workflow.simulator import ClusterMetrics, SimResult, simulate
