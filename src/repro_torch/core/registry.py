"""(Role, Type) -> execution-function registry (paper §5, Fig. 5): the
port's copy of ``repro.core.registry``, bound to the port's stages.

The DAG Worker binds each node to its computational function through this
table at initialization. Researchers extend the pipeline by registering a new
function for a (role, type) key — or overriding a built-in — without touching
the surrounding dataflow (the paper's pluggability story).

Every stage function has the uniform signature::

    fn(ctx: WorkerContext, buffer: DistributedDatabuffer, node: Node) -> dict

reading its inputs from / writing its outputs to the databuffer under the
node's stage sharding.
"""
from __future__ import annotations

import difflib
from typing import Callable, Dict, Tuple

from repro_torch.core.dag import Node, NodeType, Role

StageFn = Callable[..., Dict]


def _key_str(key: Tuple[Role, NodeType]) -> str:
    return f"{key[0].value}/{key[1].value}"


class Registry:
    def __init__(self):
        self._fns: Dict[Tuple[Role, NodeType], StageFn] = {}

    def _registered_str(self) -> str:
        return ", ".join(sorted(_key_str(k) for k in self._fns)) or "<none>"

    def register(self, role: Role, type_: NodeType, fn: StageFn, *, override=False):
        key = (role, type_)
        if key in self._fns and not override:
            bound = getattr(self._fns[key], "__name__", repr(self._fns[key]))
            raise KeyError(
                f"({_key_str(key)}) already registered (bound to {bound}); "
                f"pass override=True to replace it. "
                f"Registered keys: [{self._registered_str()}]"
            )
        self._fns[key] = fn
        return fn

    def resolve(self, node: Node) -> StageFn:
        try:
            return self._fns[node.fn_key]
        except KeyError:
            want = _key_str(node.fn_key)
            near = difflib.get_close_matches(
                want, [_key_str(k) for k in self._fns], n=1, cutoff=0.4
            )
            hint = f" Nearest match: {near[0]}." if near else ""
            raise KeyError(
                f"no function registered for node {node.node_id!r} with "
                f"(role={node.role.value}, type={node.type.value}). "
                f"Registered keys: [{self._registered_str()}].{hint}"
            ) from None

    def keys(self):
        return list(self._fns)


def default_registry() -> Registry:
    """The built-in PPO/GRPO function table (lazily imported to avoid
    circular deps)."""
    from repro_torch.core import stages

    r = Registry()
    r.register(Role.ACTOR, NodeType.GENERATE, stages.actor_generate)
    r.register(Role.ACTOR, NodeType.MODEL_INFERENCE, stages.actor_logprobs)
    r.register(Role.REFERENCE, NodeType.MODEL_INFERENCE, stages.reference_logprobs)
    r.register(Role.CRITIC, NodeType.MODEL_INFERENCE, stages.critic_values)
    r.register(Role.REWARD, NodeType.COMPUTE, stages.reward_compute)
    r.register(Role.ENV, NodeType.COMPUTE, stages.env_compute)
    r.register(Role.ADVANTAGE, NodeType.COMPUTE, stages.advantage_compute)
    r.register(Role.ACTOR, NodeType.MODEL_TRAIN, stages.actor_train)
    r.register(Role.CRITIC, NodeType.MODEL_TRAIN, stages.critic_train)
    return r
