"""Environment / reward plugin contracts + registries: a copy of
``repro.rl.envs.base`` (the JAX module imports no JAX).

DistFlow's usability claim is that the DAG executes "complex execution
flows" beyond the fixed single-turn PPO loop; HybridFlow makes the same case
for RLHF dataflows as composable programs. This module is the *workload*
half of that contract, mirroring :mod:`repro_torch.rl.algorithms`: an
:class:`EnvSpec` names a factory for per-episode :class:`Environment`
instances (multi-turn tool use, dialog, or a plain single-turn function
reward), a :class:`RewardSpec` names the scoring functions the REWARD/ENV
stages call, and both live in register/get/list registries with the same
nearest-match ``KeyError`` messages as the algorithm registry.

Episode lifecycle (driven by the continuous rollout engine, host side)::

    env = runtime.make_episode()
    obs = env.reset(prompt_tokens)          # turn-1 context (prefilled)
    while True:
        response = <engine decodes one turn from the policy>
        obs, reward, done, info = env.step(response)
        if done: break
        # `obs` re-enters the prompt queue appended to the episode's KV rows

Environments are *host-side* and token-native: ``reset``/``step`` take and
return 1-D ``np.ndarray`` token ids (the engine never decodes text; envs own
their tokenizer use). See ``docs/environments.md`` for the full lifecycle,
KV-reuse, and masking contracts.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Callable, Dict, List, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


@runtime_checkable
class Environment(Protocol):
    """One episode. ``reset`` returns the turn-1 observation tokens (usually
    the prompt itself, at most the prompt's padded length); ``step`` consumes
    the policy's turn response and returns ``(obs_tokens, reward, done,
    info)`` — ``obs_tokens`` is the next turn's appended context (ignored
    when ``done``)."""

    def reset(self, prompt: np.ndarray) -> np.ndarray: ...

    def step(
        self, response: np.ndarray
    ) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]: ...


# --------------------------------------------------------------------------- #
# specs
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """A registered environment: ``factory(tok, env_cfg)`` builds one fresh
    per-episode :class:`Environment`. ``multi_turn`` declares whether the env
    ever continues past turn 1 (single-turn envs run on either generation
    engine; multi-turn needs the continuous engine's episode loop)."""

    name: str
    factory: Callable[[ByteTokenizer, Any], Environment]
    multi_turn: bool = False
    description: str = ""


@dataclasses.dataclass(frozen=True)
class RewardSpec:
    """A registered function reward, in both execution forms: ``host_fn(texts,
    answers) -> np.ndarray`` for host-side env scoring, and ``token_fn(tokens,
    mask, answers, tok) -> torch.Tensor`` for the REWARD stage. The two
    must agree on well-formed (EOS-terminated) rollouts."""

    name: str
    host_fn: Callable[[List[str], np.ndarray], np.ndarray]
    token_fn: Callable
    description: str = ""


# --------------------------------------------------------------------------- #
# registries (mirroring rl/algorithms.py)
# --------------------------------------------------------------------------- #
_ENVS: Dict[str, EnvSpec] = {}
_REWARDS: Dict[str, RewardSpec] = {}


def register_env(spec: EnvSpec, *, override: bool = False) -> EnvSpec:
    if spec.name in _ENVS and not override:
        raise KeyError(
            f"environment {spec.name!r} already registered "
            f"(pass override=True to replace). Registered: {list_envs()}"
        )
    _ENVS[spec.name] = spec
    return spec


def get_env(name: str) -> EnvSpec:
    try:
        return _ENVS[name]
    except KeyError:
        near = difflib.get_close_matches(name, _ENVS, n=1)
        hint = f"; did you mean {near[0]!r}?" if near else ""
        raise KeyError(
            f"unknown environment {name!r}. Registered: {list_envs()}{hint}"
        ) from None


def list_envs() -> List[str]:
    return sorted(_ENVS)


def register_reward(spec: RewardSpec, *, override: bool = False) -> RewardSpec:
    if spec.name in _REWARDS and not override:
        raise KeyError(
            f"reward {spec.name!r} already registered "
            f"(pass override=True to replace). Registered: {list_rewards()}"
        )
    _REWARDS[spec.name] = spec
    return spec


def get_reward(name: str) -> RewardSpec:
    try:
        return _REWARDS[name]
    except KeyError:
        near = difflib.get_close_matches(name, _REWARDS, n=1)
        hint = f"; did you mean {near[0]!r}?" if near else ""
        raise KeyError(
            f"unknown reward {name!r}. Registered: {list_rewards()}{hint}"
        ) from None


def list_rewards() -> List[str]:
    return sorted(_REWARDS)


# --------------------------------------------------------------------------- #
# DAG transform
# --------------------------------------------------------------------------- #
def with_env_stage(dag):
    """Swap every (REWARD, COMPUTE) node in ``dag`` for an (ENV, COMPUTE)
    node named ``env_compute``, rewiring dependents. This is how an enabled
    :class:`~repro_torch.configs.base.EnvConfig` retargets an algorithm's built-in
    DAG template: the env stage satisfies the algorithm's REWARD role
    (:meth:`~repro_torch.rl.algorithms.AlgorithmSpec.validate_dag` treats ENV as
    providing REWARD) and writes the same ``rewards`` buffer key."""
    from repro_torch.core.dag import DAG, Node, NodeType, Role

    renames = {
        n.node_id: "env_compute"
        for n in dag.nodes.values()
        if n.role == Role.REWARD and n.type == NodeType.COMPUTE
    }
    if not renames:
        return dag
    if len(renames) > 1:
        raise ValueError(
            f"cannot retarget a DAG with multiple REWARD/COMPUTE nodes "
            f"({sorted(renames)}) to an environment stage"
        )
    nodes = []
    for n in dag.nodes.values():
        deps = tuple(renames.get(d, d) for d in n.deps)
        if n.node_id in renames:
            nodes.append(Node(renames[n.node_id], Role.ENV, NodeType.COMPUTE,
                              deps=deps, parallelism=dict(n.parallelism)))
        else:
            nodes.append(Node(n.node_id, n.role, n.type, deps=deps,
                              parallelism=dict(n.parallelism)))
    return DAG.from_nodes(nodes)


# --------------------------------------------------------------------------- #
# runtime binding
# --------------------------------------------------------------------------- #
class EnvRuntime:
    """A bound (EnvSpec, EnvConfig, tokenizer) triple — what the pipeline
    threads through ``WorkerContext.env`` and hands the rollout engine.

    ``make_episode`` builds one fresh env per rollout sequence per iteration;
    ``score_single_turn`` is the lockstep-engine path for single-turn envs
    (the ENV stage steps each episode post-hoc over the finished rollout)."""

    def __init__(self, spec: EnvSpec, cfg, tok: ByteTokenizer):
        if cfg.max_turns > 1 and not spec.multi_turn:
            multi = [n for n in list_envs() if _ENVS[n].multi_turn]
            raise ValueError(
                f"environment {spec.name!r} is single-turn; max_turns="
                f"{cfg.max_turns} needs a multi_turn env ({multi})"
            )
        self.spec = spec
        self.cfg = cfg
        self.tok = tok

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def max_turns(self) -> int:
        return self.cfg.max_turns

    def make_episode(self) -> Environment:
        return self.spec.factory(self.tok, self.cfg)

    def score_single_turn(
        self, tokens: np.ndarray, mask: np.ndarray
    ) -> np.ndarray:
        """Step every episode once over a finished lockstep rollout: row b's
        prompt is the (non-pad) prefix before its first response token, its
        response the masked tokens. Returns per-sequence rewards."""
        tokens = np.asarray(tokens)
        mask = np.asarray(mask, bool)
        B = tokens.shape[0]
        rewards = np.zeros(B, np.float32)
        for b in range(B):
            m = mask[b]
            first = int(np.argmax(m)) if m.any() else tokens.shape[1]
            prompt = tokens[b, :first]
            prompt = prompt[: int(np.max(np.nonzero(
                prompt != self.tok.pad_id)[0])) + 1] if (
                prompt != self.tok.pad_id).any() else prompt[:1]
            env = self.make_episode()
            env.reset(prompt)
            _, r, _, _ = env.step(tokens[b][m])
            rewards[b] = r
        return rewards
