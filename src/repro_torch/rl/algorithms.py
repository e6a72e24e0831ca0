"""First-class algorithm plugins: :class:`AlgorithmSpec` + registry (port of
``repro.rl.algorithms``; the DAGs come from the port's ``core.dag``).

The paper's usability claim (§4.1) is that researchers define their entire RL
workflow declaratively and the framework executes it without modification.
This module is the algorithm half of that contract: an ``AlgorithmSpec``
bundles everything that used to be ``if rl.algorithm == ...`` branches spread
over four layers — the DAG template, the advantage estimator, the actor loss,
rollout group semantics, and the roles the DAG must provide. The core layers
(pipeline / stages / worker / trainer) only ever see the spec's callables;
adding an algorithm is one ``register_algorithm`` call (see
``docs/algorithms.md``).

Built-ins, as in the JAX package: ``grpo`` and ``ppo``, plus ``rloo``
(REINFORCE with a leave-one-out baseline) and ``reinforce_pp`` (REINFORCE++: global-batch
advantage normalization, no critic).
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Callable, Dict, FrozenSet, List, Tuple

import torch

from repro_torch.core.dag import DAG, DAGError, Node, NodeType, Role
from repro_torch.rl import advantage as adv_mod
from repro_torch.rl import loss as losses


# --------------------------------------------------------------------------- #
# built-in DAG templates (paper Fig. 1)
# --------------------------------------------------------------------------- #
def grpo_dag() -> DAG:
    return DAG.from_nodes(
        [
            Node("actor_generation", Role.ACTOR, NodeType.GENERATE),
            Node("reference_inference", Role.REFERENCE, NodeType.MODEL_INFERENCE,
                 deps=("actor_generation",)),
            Node("reward_compute", Role.REWARD, NodeType.COMPUTE,
                 deps=("actor_generation",)),
            Node("advantage_compute", Role.ADVANTAGE, NodeType.COMPUTE,
                 deps=("reward_compute",)),
            Node("actor_train", Role.ACTOR, NodeType.MODEL_TRAIN,
                 deps=("reference_inference", "advantage_compute")),
        ]
    )


def ppo_dag() -> DAG:
    return DAG.from_nodes(
        [
            Node("actor_generation", Role.ACTOR, NodeType.GENERATE),
            Node("reference_inference", Role.REFERENCE, NodeType.MODEL_INFERENCE,
                 deps=("actor_generation",)),
            Node("reward_compute", Role.REWARD, NodeType.COMPUTE,
                 deps=("actor_generation",)),
            Node("critic_inference", Role.CRITIC, NodeType.MODEL_INFERENCE,
                 deps=("actor_generation",)),
            Node("advantage_compute", Role.ADVANTAGE, NodeType.COMPUTE,
                 deps=("reward_compute", "critic_inference",
                       "reference_inference")),
            Node("actor_train", Role.ACTOR, NodeType.MODEL_TRAIN,
                 deps=("advantage_compute",)),
            Node("critic_train", Role.CRITIC, NodeType.MODEL_TRAIN,
                 deps=("advantage_compute",)),
        ]
    )


def critic_free_dag() -> DAG:
    """Reference-free, critic-free chain (REINFORCE-family algorithms)."""
    return DAG.from_nodes(
        [
            Node("actor_generation", Role.ACTOR, NodeType.GENERATE),
            Node("reward_compute", Role.REWARD, NodeType.COMPUTE,
                 deps=("actor_generation",)),
            Node("advantage_compute", Role.ADVANTAGE, NodeType.COMPUTE,
                 deps=("reward_compute",)),
            Node("actor_train", Role.ACTOR, NodeType.MODEL_TRAIN,
                 deps=("advantage_compute",)),
        ]
    )


# --------------------------------------------------------------------------- #
# the spec
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """Everything the framework needs to run one RL algorithm.

    ``make_advantage(rl)`` returns the advantage engine; its
    positional signature is ``(rewards, mask, *advantage_inputs)`` where
    ``advantage_inputs`` names the extra databuffer keys it consumes, and it
    returns one array per ``advantage_outputs`` entry (a single array when
    there is exactly one output). On a rank mesh it gets this rank's rows
    and a keyword ``total``, a function that sums a tensor over the ranks,
    through which a normalisation over the batch sums its moments.

    ``actor_loss(rl, logprob, batch)`` returns a metrics dict containing
    ``"loss"`` — the pre-entropy policy objective (the trainer adds the
    entropy bonus and metric uniformly).
    """

    name: str
    dag_factory: Callable[[], DAG]
    make_advantage: Callable[[Any], Callable]
    actor_loss: Callable[[Any, torch.Tensor, Dict[str, torch.Tensor]], Dict]
    # extra buffer keys the advantage engine reads after (rewards, mask)
    advantage_inputs: Tuple[str, ...] = ()
    # buffer keys the advantage engine writes, in return order
    advantage_outputs: Tuple[str, ...] = ("advantages",)
    # roles a DAG must contain to run this algorithm
    required_roles: FrozenSet[Role] = frozenset(
        {Role.ACTOR, Role.REWARD, Role.ADVANTAGE}
    )
    # rollouts are sampled in prompt groups of rl.group_size (GRPO semantics)
    grouped_rollouts: bool = False
    # actor batch carries ref_logprob (falls back to old_logprob when the DAG
    # has no reference node — the zero-KL variant)
    needs_reference: bool = False
    # off-policy correction under the async pipeline (docs/async_pipeline.md):
    #   "none"      — train stale batches as-is (the PPO/GRPO ratio vs the
    #                 behaviour logprobs absorbs the staleness);
    #   "truncated" — decoupled truncated importance sampling: the scheduler
    #                 recomputes old_logprob under the train-time (proximal)
    #                 policy and the trainer weights the surrogate by
    #                 min(exp(proximal - behaviour), rl.is_rho_max).
    # Only consulted for batches whose staleness is >= 1; the synchronous
    # path and max_staleness=0 never see it.
    is_correction: str = "none"
    description: str = ""

    def __post_init__(self):
        if self.is_correction not in ("none", "truncated"):
            raise ValueError(
                f"is_correction must be 'none' or 'truncated', "
                f"got {self.is_correction!r}"
            )

    @property
    def uses_critic(self) -> bool:
        return Role.CRITIC in self.required_roles

    def group_size(self, rl) -> int:
        """Rollouts per prompt for this algorithm under ``rl``."""
        return rl.group_size if self.grouped_rollouts else 1

    def validate_dag(self, dag: DAG) -> None:
        """Raise :class:`DAGError` if ``dag`` lacks a role this algorithm
        requires (e.g. a PPO run on a DAG without a critic node)."""
        have = {n.role for n in dag.nodes.values()}
        if Role.ENV in have:
            # an environment stage writes the same `rewards` buffer key the
            # REWARD stage would (repro.rl.envs.with_env_stage)
            have.add(Role.REWARD)
        missing = self.required_roles - have
        if missing:
            raise DAGError(
                f"DAG is missing required roles for algorithm {self.name!r}: "
                f"{sorted(r.value for r in missing)} "
                f"(DAG roles: {sorted(r.value for r in have)})"
            )


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #
_ALGORITHMS: Dict[str, AlgorithmSpec] = {}


def register_algorithm(spec: AlgorithmSpec, *, override: bool = False) -> AlgorithmSpec:
    if spec.name in _ALGORITHMS and not override:
        raise KeyError(
            f"algorithm {spec.name!r} already registered "
            f"(pass override=True to replace). Registered: {list_algorithms()}"
        )
    _ALGORITHMS[spec.name] = spec
    return spec


def get_algorithm(name: str) -> AlgorithmSpec:
    try:
        return _ALGORITHMS[name]
    except KeyError:
        near = difflib.get_close_matches(name, _ALGORITHMS, n=1)
        hint = f"; did you mean {near[0]!r}?" if near else ""
        raise KeyError(
            f"unknown algorithm {name!r}. Registered: {list_algorithms()}{hint}"
        ) from None


def list_algorithms() -> List[str]:
    return sorted(_ALGORITHMS)


def resolve(ctx) -> AlgorithmSpec:
    """The spec for a worker context: the bound spec if the pipeline attached
    one, else the registry entry for ``ctx.rl.algorithm``."""
    spec = getattr(ctx, "algorithm", None)
    return spec if spec is not None else get_algorithm(ctx.rl.algorithm)


# --------------------------------------------------------------------------- #
# built-in actor losses
# --------------------------------------------------------------------------- #
def _grpo_actor_loss(rl, logprob, batch):
    return losses.grpo_loss(
        logprob,
        batch["old_logprob"],
        batch["ref_logprob"],
        batch["advantages"],
        batch["response_mask"],
        clip_eps=rl.clip_eps,
        kl_coef=rl.kl_coef,
    )


def _clip_actor_loss(rl, logprob, batch):
    return losses.ppo_policy_loss(
        logprob, batch["old_logprob"], batch["advantages"],
        batch["response_mask"], clip_eps=rl.clip_eps,
    )


# public aliases: reusable loss building blocks for custom specs
grpo_actor_loss = _grpo_actor_loss
clip_actor_loss = _clip_actor_loss


# --------------------------------------------------------------------------- #
# built-in advantage engines
# --------------------------------------------------------------------------- #
# A rank holds whole prompt groups, so the group estimators need no
# ``total``; the batch normalisations sum their moments through it.
def _make_grpo_advantage(rl):
    return lambda rewards, mask, total=None: adv_mod.grpo(
        rewards, mask, group_size=rl.group_size
    )


def _make_ppo_advantage(rl):
    def _ppo_adv(rewards, mask, old_lp, ref_lp, values, total=None):
        B, T = mask.shape
        kl = old_lp - ref_lp  # per-token KL estimate (k1)
        m = mask.float()
        # terminal reward at the last response token
        last = torch.clamp(torch.sum(m, dim=1) - 1, min=0).long()
        first = torch.argmax(mask.to(torch.int32), dim=1)
        pos = torch.clamp(first + last, 0, T - 1)
        tok_rewards = -rl.kl_coef * kl * m
        rows = torch.arange(B, device=mask.device)
        tok_rewards = tok_rewards.index_put((rows, pos), rewards.float(), accumulate=True)
        adv, ret = adv_mod.gae(
            tok_rewards, values * m, m, gamma=rl.gamma, lam=rl.gae_lambda
        )
        return adv_mod.whiten(adv, m, total=total), ret

    return _ppo_adv


def _make_rloo_advantage(rl):
    return lambda rewards, mask, total=None: adv_mod.rloo(
        rewards, mask, group_size=rl.group_size
    )


def _make_reinforce_pp_advantage(rl):
    return lambda rewards, mask, total=None: adv_mod.reinforce_pp(rewards, mask, total=total)


# --------------------------------------------------------------------------- #
# built-in specs
# --------------------------------------------------------------------------- #
GRPO = register_algorithm(AlgorithmSpec(
    name="grpo",
    dag_factory=grpo_dag,
    make_advantage=_make_grpo_advantage,
    actor_loss=_grpo_actor_loss,
    grouped_rollouts=True,
    needs_reference=True,
    description="Group-relative policy optimization: per-prompt-group "
                "normalized advantages, clipped surrogate + k3 KL penalty.",
))

PPO = register_algorithm(AlgorithmSpec(
    name="ppo",
    dag_factory=ppo_dag,
    make_advantage=_make_ppo_advantage,
    actor_loss=_clip_actor_loss,
    advantage_inputs=("old_logprob", "ref_logprob", "old_values"),
    advantage_outputs=("advantages", "returns"),
    required_roles=frozenset(
        {Role.ACTOR, Role.REWARD, Role.ADVANTAGE, Role.CRITIC, Role.REFERENCE}
    ),
    description="PPO with a same-size critic: KL-shaped token rewards, GAE, "
                "whitened advantages, clipped policy + value losses.",
))

RLOO = register_algorithm(AlgorithmSpec(
    name="rloo",
    dag_factory=grpo_dag,
    make_advantage=_make_rloo_advantage,
    actor_loss=_grpo_actor_loss,
    grouped_rollouts=True,
    needs_reference=True,
    description="REINFORCE leave-one-out: each rollout's baseline is the mean "
                "reward of the other group members; clipped surrogate + KL.",
))

REINFORCE_PP = register_algorithm(AlgorithmSpec(
    name="reinforce_pp",
    dag_factory=critic_free_dag,
    make_advantage=_make_reinforce_pp_advantage,
    actor_loss=_clip_actor_loss,
    grouped_rollouts=True,
    description="REINFORCE++: global-batch-normalized sequence advantages, "
                "clipped surrogate, no critic and no reference model.",
))
