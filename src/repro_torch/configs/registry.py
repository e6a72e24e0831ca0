"""``--arch <id>`` registry over the architectures (a copy of
``repro.configs.registry`` without the dry-run shape cells)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig

from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.jamba_52b import CONFIG as JAMBA_52B
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from repro_torch.configs.nemotron_4_15b import CONFIG as NEMOTRON_4_15B
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.command_r_plus_104b import CONFIG as COMMAND_R_PLUS_104B
from repro_torch.configs.granite_moe_3b import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.llava_next_34b import CONFIG as LLAVA_NEXT_34B
from repro_torch.configs.qwen2_5_7b import CONFIG as QWEN2_5_7B

ARCHS: Dict[str, ModelConfig] = {
    "mamba2-2.7b": MAMBA2_2_7B,
    "jamba-v0.1-52b": JAMBA_52B,
    "seamless-m4t-medium": SEAMLESS_M4T_MEDIUM,
    "nemotron-4-15b": NEMOTRON_4_15B,
    "gemma-2b": GEMMA_2B,
    "deepseek-67b": DEEPSEEK_67B,
    "command-r-plus-104b": COMMAND_R_PLUS_104B,
    "granite-moe-3b-a800m": GRANITE_MOE_3B,
    "mixtral-8x7b": MIXTRAL_8X7B,
    "llava-next-34b": LLAVA_NEXT_34B,
    # the paper's own model family:
    "qwen2.5-7b": QWEN2_5_7B,
}

ASSIGNED = tuple(k for k in ARCHS if k != "qwen2.5-7b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ARCHS", "ASSIGNED", "get_config"]
