"""Model facade of the PyTorch port (port of ``repro.models.api``): the
serving and rollout code talks to :class:`Model` only."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


class Model:
    def __init__(self, cfg: ModelConfig, *, device="cpu"):
        lm.check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights on ``self.device`` from ``gen`` (a generator on that
        device)."""
        return lm.init(self.cfg, gen, device=self.device)

    def init_caches(self, batch: int, smax: int):
        return lm.init_caches(self.cfg, batch, smax, device=self.device)

    def prefill(self, params, tokens, *, smax: int):
        return lm.prefill(self.cfg, params, tokens, smax=smax)

    def decode_step(self, params, token, caches, cache_len):
        return lm.decode_step(self.cfg, params, token, caches, cache_len)

    def decode_step_sample(self, params, token, caches, cache_len, seeds,
                           temperature: float):
        """Decode step with the fused head + sampler. Returns (token,
        behaviour logprob, caches, cache_len + 1)."""
        return lm.decode_step_sample(self.cfg, params, token, caches, cache_len,
                                     seeds, temperature)


def get_model(cfg: ModelConfig, *, device="cpu") -> Model:
    return Model(cfg, device=device)
