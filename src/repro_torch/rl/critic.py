"""Critic (value) model for PPO (port of ``repro.rl.critic``): the LM backbone
with a scalar value head in place of the token head."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def init(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Dict[str, Any]:
    """``{"backbone": lm params without a token head, "v_head": (d, 1) fp32
    N(0, 0.01^2)}`` from ``gen`` (on ``device``)."""
    backbone = lm.init(cfg, gen, device=device)
    backbone.pop("lm_head", None)  # a value model has no token head
    v_head = torch.randn((cfg.d_model, 1), generator=gen, dtype=torch.float32, device=device)
    return {"backbone": backbone, "v_head": v_head * 0.01}


def values_fn(cfg: ModelConfig, params, tokens: torch.Tensor, *, remat: bool = False):
    """Token values (B, S) fp32."""
    h = lm.embed_tokens(cfg, params["backbone"], tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, _, _ = lm.backbone(cfg, params["backbone"], h, positions, mode="full", remat=remat)
    return (h.float() @ params["v_head"])[..., 0]
