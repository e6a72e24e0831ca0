"""Control plane of the PyTorch port: the DAG abstraction (the planner,
worker, databuffer and stages are ROADMAP queue 1, item 2)."""
from repro_torch.core.dag import DAG, DAGError, Node, NodeType, Role

__all__ = ["DAG", "DAGError", "Node", "NodeType", "Role"]
