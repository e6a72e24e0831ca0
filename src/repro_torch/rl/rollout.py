"""Lockstep rollout (generation) of the PyTorch port (port of
``repro.rl.rollout``): prefill the prompts, then ``max_new - 1`` fused
decode + sample steps. Finished rows (EOS or budget) keep emitting
``pad_id`` but stop counting. Returns the full sequences, the response mask
and the behaviour logprobs used as ``old_logprob`` by PPO/GRPO.

Sampling is the hash Gumbel-max rule of the fused sampler kernel, driven by
per-step, per-row int32 seeds drawn from an explicit ``torch.Generator``; it
is not ``jax.random.categorical``, so sampled tokens follow the same
distribution as the JAX package's but not the same stream. Greedy
(``temperature == 0``) is the first-max argmax in both packages.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.models.api import Model


class RolloutResult(NamedTuple):
    tokens: torch.Tensor  # (B, Lp + T) prompt + response (pad after EOS)
    response_mask: torch.Tensor  # (B, Lp + T) True on counted response tokens
    old_logprob: torch.Tensor  # (B, Lp + T) behaviour logprobs (0 on prompt)
    lengths: torch.Tensor  # (B,) response lengths


def row_seeds(gen: torch.Generator, batch: int) -> torch.Tensor:
    """``batch`` int32 hash seeds (every 32-bit pattern) from ``gen``, on
    ``gen``'s device."""
    return torch.randint(-2**31, 2**31, (batch,), generator=gen,
                         dtype=torch.int64, device=gen.device).to(torch.int32)


def sample_token(logits: torch.Tensor, seeds: torch.Tensor, temperature: float) -> torch.Tensor:
    """Sample from materialised (B, V) logits: argmax when greedy, else the
    fused sampler's hash Gumbel-max rule with the rows' seeds. Padded-vocab
    logits are already masked to -1e30 by the model."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    pos = torch.arange(logits.shape[-1], device=logits.device)
    u = _ref.uniform_01(seeds[:, None], pos[None, :])
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() * (1.0 / temperature) + g, dim=-1).to(torch.int32)


@torch.inference_mode()
def generate(
    model: Model,
    params,
    prompt: torch.Tensor,  # (B, Lp) fixed-length prompts
    gen: torch.Generator,
    *,
    max_new: int,
    temperature: float = 1.0,
    top_p: float = 1.0,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    budgets: Optional[torch.Tensor] = None,  # (B,) per-sequence response caps
) -> RolloutResult:
    """``budgets`` caps each sequence's counted response length at
    ``min(budgets[b], max_new)`` (>= 1: the first sampled token always
    counts). Lockstep runs all ``max_new`` steps regardless. ``gen`` draws
    the per-step seeds and lives on the model's device."""
    if top_p < 1.0:
        raise NotImplementedError(
            "top_p < 1 is not ported yet (ROADMAP queue 1, item 8: other families)")
    B, Lp = prompt.shape
    logits, caches, cache_len = model.prefill(params, prompt, smax=Lp + max_new)

    tok = sample_token(logits, row_seeds(gen, B), temperature)
    lp0 = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None].long())[:, 0]
    done = (tok == eos_id) if eos_id is not None else torch.zeros(
        B, dtype=torch.bool, device=tok.device)
    if budgets is not None:
        done = done | (budgets <= 1)

    toks, lps, dones = [tok], [lp0], [torch.zeros_like(done)]
    for j in range(max_new - 1):  # step j emits response position j + 2
        nxt, lp, caches, cache_len = model.decode_step_sample(
            params, tok, caches, cache_len, row_seeds(gen, B), temperature)
        nxt = torch.where(done, pad_id, nxt)
        lp = torch.where(done, 0.0, lp)
        toks.append(nxt)
        lps.append(lp)
        dones.append(done)
        new_done = done | ((nxt == eos_id) if eos_id is not None else False)
        if budgets is not None:
            new_done = new_done | (j + 2 >= budgets)
        tok, done = nxt, new_done

    resp = torch.stack(toks, dim=1)
    resp_lp = torch.stack(lps, dim=1)
    resp_mask = ~torch.stack(dones, dim=1)  # emitted while not yet done (incl. EOS)
    tokens = torch.cat([prompt.to(resp.dtype), resp], dim=1)
    zeros = torch.zeros((B, Lp), device=resp.device)
    mask = torch.cat([zeros.bool(), resp_mask], dim=1)
    old_lp = torch.cat([zeros, resp_lp * resp_mask], dim=1)
    lengths = resp_mask.sum(dim=1).to(torch.int32)
    return RolloutResult(tokens, mask, old_lp, lengths)
