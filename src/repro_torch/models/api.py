"""Model facade of the PyTorch port (port of ``repro.models.api``): the
serving and rollout code talks to :class:`Model` only, and the family
dispatch (decoder-only LM or encoder-decoder) stays here."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm


def resolve_device(name) -> torch.device:
    """``cuda`` or ``cpu`` as asked; raises when CUDA is asked for and absent
    (it never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available here; pass --device cpu "
            "(device='cpu') to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


class Model:
    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        self.cfg = cfg
        self.is_encdec = cfg.is_encoder_decoder
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights on ``self.device`` from ``gen`` (a generator on that
        device)."""
        return (encdec.init if self.is_encdec else lm.init)(self.cfg, gen, device=self.device)

    # ---- training and RL scoring ----
    def loss(self, params, batch, *, remat: bool = True):
        """Loss of ``batch`` (tokens, labels [, prefix_embeds | frames]):
        (loss, metrics)."""
        if self.is_encdec:
            return encdec.loss_fn(self.cfg, params, batch, remat=remat)
        return lm.loss_fn(self.cfg, params, batch, remat=remat)

    def logprobs(self, params, tokens, *, prefix_embeds=None, frames=None,
                 remat: bool = False):
        """(logprob, entropy) of ``tokens``, each (B, S); position 0 gets 0."""
        if self.is_encdec:
            return encdec.logprobs_fn(self.cfg, params, tokens, frames, remat=remat)
        return lm.logprobs_fn(self.cfg, params, tokens, prefix_embeds=prefix_embeds,
                              remat=remat)

    def init_caches(self, batch: int, smax: int):
        if self.is_encdec:
            return encdec.init_caches(self.cfg, batch, smax, device=self.device)
        return lm.init_caches(self.cfg, batch, smax, device=self.device)

    def prefill(self, params, tokens, *, smax: int, prefix_embeds=None, frames=None):
        if self.is_encdec:
            return encdec.prefill(self.cfg, params, tokens, frames, smax=smax)
        return lm.prefill(self.cfg, params, tokens, smax=smax, prefix_embeds=prefix_embeds)

    def decode_step(self, params, token, caches, cache_len):
        if self.is_encdec:
            return encdec.decode_step(self.cfg, params, token, caches, cache_len)
        return lm.decode_step(self.cfg, params, token, caches, cache_len)

    def decode_step_sample(self, params, token, caches, cache_len, seeds,
                           temperature: float, *, top_p: float = 1.0):
        """Decode step with the fused head + sampler (LM only). Returns
        (token, behaviour logprob, caches, cache_len + 1); ``top_p < 1``
        samples through the plain sampler, as in JAX."""
        if self.is_encdec:
            raise NotImplementedError("fused sampling is decoder-only")
        return lm.decode_step_sample(self.cfg, params, token, caches, cache_len,
                                     seeds, temperature, top_p=top_p)

    # ---- streaming serving: paged decode over the page pool ----
    def decode_step_paged(self, params, token, pool, cache_len, page_tables,
                          *, write_enable=None):
        """Paged decode step over a shared page pool (LM only)."""
        if self.is_encdec:
            raise NotImplementedError("paged decode is decoder-only")
        return lm.decode_step_paged(self.cfg, params, token, pool, cache_len,
                                    page_tables, write_enable=write_enable)

    def decode_step_paged_sample(self, params, token, pool, cache_len,
                                 page_tables, seeds, temps, *, write_enable=None):
        """Paged decode + fused per-row sampling (the serving burst step)."""
        if self.is_encdec:
            raise NotImplementedError("paged decode is decoder-only")
        return lm.decode_step_paged_sample(self.cfg, params, token, pool,
                                           cache_len, page_tables, seeds, temps,
                                           write_enable=write_enable)

    def prefill_chunk(self, params, tokens, caches, *, offset: int):
        """One chunk of a chunked prefill into existing caches (see
        ``lm.prefill_chunk``)."""
        if self.is_encdec:
            raise NotImplementedError(
                "chunked prefill is decoder-only; enc-dec prefill runs the "
                "encoder over the whole input")
        return lm.prefill_chunk(self.cfg, params, tokens, caches, offset=offset)

    def gather_cache_rows(self, caches, slots):
        return lm.gather_cache_rows(caches, slots)

    def scatter_cache_rows(self, caches, rows, slots):
        """Slot-reset: overwrite arena rows at ``slots`` with fresh rows."""
        return lm.scatter_cache_rows(caches, rows, slots)

    def gather_cache_pages(self, caches, slots, *, num_pages, page_size):
        """Page-granular gather: leaves (R, num_pages, page_size, ...)."""
        return lm.gather_cache_pages(caches, slots, num_pages=num_pages,
                                     page_size=page_size)

    def scatter_cache_pages(self, caches, pages, slots):
        """Write page stacks contiguously into arena rows at ``slots``."""
        return lm.scatter_cache_pages(caches, pages, slots)


def get_model(cfg: ModelConfig, *, device="cuda") -> Model:
    return Model(cfg, device=device)
