"""DAG Planner (paper §4.2, Fig. 4): the port's copy of ``repro.core.planner``.

Translates the logical DAG into a linearized execution pipeline safe for a
colocated cluster where all models share one resource pool: nodes at the same
logical depth (would-be parallel) are serialized by injecting dependencies, so
only one node is ever active — avoiding resource contention / OOM from two
engines running at once. The planner then replicates the resulting task chain
across DAG Workers (every worker executes the same chain on its own data
shard — the multi-controller SPMD execution model).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dag import DAG, Node, NodeType, Role


@dataclass(frozen=True)
class StageTask:
    """Smallest executable unit dispatched to a DAG Worker."""

    node: Node
    order: int  # position in the serialized chain
    # the serialized predecessor (includes injected serialization edges)
    after: Optional[str]


@dataclass(frozen=True)
class ExecutionPlan:
    tasks: Tuple[StageTask, ...]
    injected_edges: Tuple[Tuple[str, str], ...]  # (prerequisite, node)

    @property
    def order(self) -> List[str]:
        return [t.node.node_id for t in self.tasks]


class DAGPlanner:
    """Decompose + serialize a user DAG into a per-worker task chain."""

    def plan(self, dag: DAG) -> ExecutionPlan:
        tasks: List[StageTask] = []
        injected: List[Tuple[str, str]] = []
        prev: Optional[str] = None
        for level in dag.levels():
            # Same-depth nodes imply parallel execution: serialize them in a
            # deterministic (node_id) order, injecting an edge from each to
            # the next (paper Fig. 4: Inference I becomes a prerequisite of
            # Inference II).
            for n in level:
                if prev is not None and prev not in n.deps:
                    injected.append((prev, n.node_id))
                tasks.append(StageTask(node=n, order=len(tasks), after=prev))
                prev = n.node_id
        return ExecutionPlan(tasks=tuple(tasks), injected_edges=tuple(injected))

    def plan_for_workers(self, dag: DAG, num_workers: int) -> List[ExecutionPlan]:
        """Replicate the chain across workers (paper §3: DAG tasks 'can be
        replicated across different DAG Workers', one per GPU). Every worker
        receives an identical chain; the Data Coordinator gives each its own
        data shard."""
        plan = self.plan(dag)
        return [plan] * num_workers


def validate_serialization(plan: ExecutionPlan) -> bool:
    """Invariant: at most one node active at any time — i.e. the chain is a
    total order consistent with all (original + injected) edges."""
    pos = {t.node.node_id: i for i, t in enumerate(plan.tasks)}
    for t in plan.tasks:
        for d in t.node.deps:
            if pos[d] >= pos[t.node.node_id]:
                return False
    for pre, nxt in plan.injected_edges:
        if pos[pre] >= pos[nxt]:
            return False
    return True
