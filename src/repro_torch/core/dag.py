"""The user-facing DAG abstraction (paper §4.1): the port's own copy of
``repro.core.dag``, which imports no JAX (the port imports nothing of the JAX
package).

A node is (Node ID, Role, Type, Dependencies) exactly as the paper defines:
Role names the functional model (ACTOR / CRITIC / REWARD / REFERENCE / ...),
Type names the computation class (GENERATE / MODEL_INFERENCE / MODEL_TRAIN /
COMPUTE), and Dependencies fix the data flow. DAGs are declared in python or
loaded from a JSON config file — the "researchers define their entire RL
workflow in a DAG" interface.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class Role(str, enum.Enum):
    ACTOR = "actor"
    CRITIC = "critic"
    REWARD = "reward"
    REFERENCE = "reference"
    ADVANTAGE = "advantage"
    ENV = "env"  # environment stage: episode rewards in place of REWARD
    DATA = "data"


class NodeType(str, enum.Enum):
    GENERATE = "generate"
    MODEL_INFERENCE = "model_inference"
    MODEL_TRAIN = "model_train"
    COMPUTE = "compute"


@dataclass(frozen=True)
class Node:
    node_id: str
    role: Role
    type: NodeType
    deps: Tuple[str, ...] = ()
    # per-stage resource config (paper: "each stage may employ different
    # parallel strategies"): logical dp/tp requested for this node's engine.
    parallelism: Dict[str, int] = field(default_factory=dict)

    @property
    def fn_key(self) -> Tuple[Role, NodeType]:
        return (self.role, self.type)


class DAGError(ValueError):
    pass


@dataclass
class DAG:
    nodes: Dict[str, Node]

    def __post_init__(self):
        self.validate()

    @classmethod
    def from_nodes(cls, nodes: Sequence[Node]) -> "DAG":
        d = {}
        for n in nodes:
            if n.node_id in d:
                raise DAGError(f"duplicate node id {n.node_id!r}")
            d[n.node_id] = n
        return cls(nodes=d)

    @classmethod
    def from_spec(cls, spec: Dict) -> "DAG":
        """Build a DAG from the in-memory config form: a dict with a
        ``nodes`` list (the same schema ``to_spec``/``to_json`` emit). This
        is what lets DAG definitions travel inside an ExperimentSpec instead
        of requiring a file on disk."""
        if "nodes" not in spec:
            raise DAGError("DAG spec must contain a 'nodes' list")
        nodes = [
            Node(
                node_id=n["id"],
                role=Role(n["role"]),
                type=NodeType(n["type"]),
                deps=tuple(n.get("deps", ())),
                parallelism=dict(n.get("parallelism", {})),
            )
            for n in spec["nodes"]
        ]
        return cls.from_nodes(nodes)

    @classmethod
    def loads(cls, s: str) -> "DAG":
        """Parse a DAG from a JSON string (``to_json`` round-trips)."""
        return cls.from_spec(json.loads(s))

    @classmethod
    def from_json(cls, path: str) -> "DAG":
        """Load the paper's config-file form from a file path."""
        with open(path) as f:
            return cls.from_spec(json.load(f))

    def validate(self) -> None:
        for n in self.nodes.values():
            for d in n.deps:
                if d not in self.nodes:
                    raise DAGError(f"{n.node_id}: unknown dependency {d!r}")
        # acyclicity via depth computation (raises on cycles)
        self.depths()

    def depths(self) -> Dict[str, int]:
        """Longest-path depth per node; DAGError on cycles."""
        memo: Dict[str, int] = {}
        visiting = set()

        def depth(nid: str) -> int:
            if nid in memo:
                return memo[nid]
            if nid in visiting:
                raise DAGError(f"cycle through {nid!r}")
            visiting.add(nid)
            n = self.nodes[nid]
            memo[nid] = 0 if not n.deps else 1 + max(depth(d) for d in n.deps)
            visiting.discard(nid)
            return memo[nid]

        for nid in self.nodes:
            depth(nid)
        return memo

    def levels(self) -> List[List[Node]]:
        """Nodes grouped by depth (ascending); same-level nodes are the
        'parallel nodes' the planner must serialize (paper Fig. 4)."""
        depths = self.depths()
        out: Dict[int, List[Node]] = {}
        for nid, d in depths.items():
            out.setdefault(d, []).append(self.nodes[nid])
        return [sorted(out[d], key=lambda n: n.node_id) for d in sorted(out)]

    def to_spec(self) -> Dict:
        """The in-memory config form (inverse of ``from_spec``)."""
        return {
            "nodes": [
                {
                    "id": n.node_id,
                    "role": n.role.value,
                    "type": n.type.value,
                    "deps": list(n.deps),
                    "parallelism": dict(n.parallelism),
                }
                for n in self.nodes.values()
            ]
        }

    def to_json(self) -> str:
        return json.dumps(self.to_spec(), indent=2)
