"""Workflow substrate: DAGs, synthetic nf-core-calibrated traces (with
memory-over-time usage curves), the serial online execution simulator with
time-to-failure semantics (paper §III-A), and the event-driven multi-node
cluster engine (with temporal RESIZE support) and its crash-recovery
journal. Copies of the reference's framework-free modules."""
from repro_torch.workflow.trace import TaskInstance, WorkflowTrace
from repro_torch.workflow.dag import WorkflowDAG
from repro_torch.workflow.accounting import (FAILURE_STRATEGIES, MAX_ATTEMPTS,
                                             AttemptLedger, TaskOutcome)
from repro_torch.workflow.generators import WORKFLOWS, generate_workflow
from repro_torch.workflow.simulator import ClusterMetrics, SimResult, simulate
from repro_torch.workflow.cluster import (ClusterEngine, Node, NodeSpec,
                                          node_specs_from_caps,
                                          node_specs_from_racks,
                                          simulate_cluster)
from repro_torch.workflow.journal import Journal, recover_run
