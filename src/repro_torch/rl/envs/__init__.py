"""Multi-turn agentic environments + pluggable rewards of the PyTorch port
(copies of ``repro.rl.envs``; docs/environments.md describes both).

Importing the package registers the built-ins: envs ``function_reward`` /
``calculator`` / ``dialog`` and reward ``math``.
"""
from repro_torch.rl.envs.base import (
    Environment,
    EnvRuntime,
    EnvSpec,
    RewardSpec,
    get_env,
    get_reward,
    list_envs,
    list_rewards,
    register_env,
    register_reward,
    with_env_stage,
)
from repro_torch.rl.envs.builtin import (
    CalculatorToolEnv,
    FunctionRewardEnv,
    MultiTurnDialogEnv,
)

__all__ = [
    "Environment",
    "EnvRuntime",
    "EnvSpec",
    "RewardSpec",
    "get_env",
    "get_reward",
    "list_envs",
    "list_rewards",
    "register_env",
    "register_reward",
    "with_env_stage",
    "CalculatorToolEnv",
    "FunctionRewardEnv",
    "MultiTurnDialogEnv",
]
