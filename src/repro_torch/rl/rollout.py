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
    # (B, L) int8 per-token roles of a multi-turn episode: 0 prompt or pad, 1
    # action, 2 env observation; response_mask == (role_mask == 1). None for
    # single-turn rollouts
    role_mask: Optional[torch.Tensor] = None


class RankRows:
    """The run's generator as one data-parallel rank sees it: a rank of
    ``count`` holding rows ``[index * B, (index + 1) * B)`` of a global batch
    of ``count * B``. :func:`row_seeds` draws the global batch's seeds from
    ``gen`` and hands back the rank's rows', so every rank advances ``gen``
    as one device would and samples its rows with that device's seeds."""

    def __init__(self, gen: torch.Generator, index: int, count: int):
        self.gen, self.index, self.count = gen, index, count

    @property
    def device(self) -> torch.device:
        return self.gen.device


def row_seeds(gen, batch: int) -> torch.Tensor:
    """``batch`` int32 hash seeds (every 32-bit pattern) from ``gen``, on
    ``gen``'s device (a :class:`RankRows` view: this rank's rows of the
    global batch's seeds)."""
    if isinstance(gen, RankRows):
        seeds = row_seeds(gen.gen, batch * gen.count)
        return seeds[gen.index * batch:(gen.index + 1) * batch]
    return torch.randint(-2**31, 2**31, (batch,), generator=gen,
                         dtype=torch.int64, device=gen.device).to(torch.int32)


def sample_token(logits: torch.Tensor, seeds: torch.Tensor, temperature: float,
                 top_p: float = 1.0) -> torch.Tensor:
    """Sample from materialised (B, V) logits: argmax when greedy, else the
    fused sampler's hash Gumbel-max rule with the rows' seeds over the
    tempered logits, restricted to their nucleus when ``top_p < 1``
    (``ref.gumbel_max_scores``, after the temperature, as in JAX).
    Padded-vocab logits are already masked to -1e30 by the model."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    pos = torch.arange(logits.shape[-1], device=logits.device)
    u = _ref.uniform_01(seeds[:, None], pos[None, :])
    g = -torch.log(-torch.log(u))
    scores = _ref.gumbel_max_scores(logits.float() * (1.0 / temperature), g, top_p)
    return torch.argmax(scores, dim=-1).to(torch.int32)


def sample_token_rows(logits: torch.Tensor, seeds: torch.Tensor,
                      temps: torch.Tensor) -> torch.Tensor:
    """:func:`sample_token` with a temperature per row (the serving engine's
    first token): rows with ``temps <= 0`` take the argmax, the others the
    hash Gumbel-max draw at ``1 / max(temps, 1e-6)``, the rule the fused
    sampler applies to its own logits (``ref.sample_scores``)."""
    inv_t = _ref.row_inv_temp(temps)[:, None]
    pos = torch.arange(logits.shape[-1], device=logits.device)
    g = -torch.log(-torch.log(_ref.uniform_01(seeds[:, None], pos[None, :])))
    z = logits.float()
    y = torch.where(inv_t == 0.0, z, z * inv_t + g)
    return torch.argmax(y, dim=-1).to(torch.int32)


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
    frames: Optional[torch.Tensor] = None,
    prefix_embeds: Optional[torch.Tensor] = None,  # (B, P, d)
) -> RolloutResult:
    """``budgets`` caps each sequence's counted response length at
    ``min(budgets[b], max_new)`` (>= 1: the first sampled token always
    counts). Lockstep runs all ``max_new`` steps regardless. ``gen`` draws
    the per-step seeds and lives on the model's device. ``top_p < 1``
    samples each row from the nucleus of its tempered distribution through
    the plain sampler; the logprobs stay those of the unfiltered
    distribution.

    With ``prefix_embeds`` the prefix runs ahead of the prompt, and the
    cache holds ``P + Lp + max_new`` positions. (The JAX package sizes it
    ``Lp + max_new``, so there its prefill keeps only the last positions, or
    its decode writes past the cache are lost, and the tokens go wrong.)
    An encoder-decoder model has no fused sampler: it raises
    ``NotImplementedError`` before its prefill, where the JAX package
    raises at its first decode step."""
    if model.is_encdec:
        raise NotImplementedError("fused sampling is decoder-only")
    B, Lp = prompt.shape
    P = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    logits, caches, cache_len = model.prefill(params, prompt, smax=P + Lp + max_new,
                                              prefix_embeds=prefix_embeds, frames=frames)

    tok = sample_token(logits, row_seeds(gen, B), temperature, top_p)
    lp0 = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None].long())[:, 0]
    done = (tok == eos_id) if eos_id is not None else torch.zeros(
        B, dtype=torch.bool, device=tok.device)
    if budgets is not None:
        done = done | (budgets <= 1)

    toks, lps, dones = [tok], [lp0], [torch.zeros_like(done)]
    for j in range(max_new - 1):  # step j emits response position j + 2
        nxt, lp, caches, cache_len = model.decode_step_sample(
            params, tok, caches, cache_len, row_seeds(gen, B), temperature, top_p=top_p)
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
