"""DistFlow core of the PyTorch port: the DAG, the planner, the registry, the
databuffer, the synchronous and the async worker and the pipeline on one
device."""
from repro_torch.core.dag import DAG, DAGError, Node, NodeType, Role
from repro_torch.core.planner import DAGPlanner, ExecutionPlan, validate_serialization
from repro_torch.core.databuffer import (
    CentralizedDatabuffer,
    DeviceMesh,
    DistributedDatabuffer,
    DoubleBufferedDatabuffer,
)
from repro_torch.core.registry import Registry, default_registry
from repro_torch.core.worker import DAGWorker, WorkerContext
from repro_torch.core.async_worker import AsyncDAGWorker, PendingRollout, PipelinedDAGWorker
from repro_torch.core.pipeline import Pipeline, build_pipeline, grpo_dag, ppo_dag

__all__ = ["AsyncDAGWorker", "CentralizedDatabuffer", "DAG", "DAGError", "DAGPlanner", "DAGWorker",
           "DeviceMesh", "DistributedDatabuffer", "DoubleBufferedDatabuffer",
           "ExecutionPlan", "Node", "NodeType", "PendingRollout", "Pipeline",
           "PipelinedDAGWorker", "Registry", "Role",
           "WorkerContext", "build_pipeline", "default_registry", "grpo_dag", "ppo_dag",
           "validate_serialization"]
