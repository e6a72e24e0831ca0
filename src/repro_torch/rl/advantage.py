"""Advantage estimators (port of ``repro.rl.advantage``): GAE (PPO),
group-relative (GRPO), leave-one-out (RLOO) and global-batch-normalised
(REINFORCE++), plus masked whitening.

On a rank mesh each rank holds its rows of the batch. A normalisation over
the whole batch (``reinforce_pp``, ``whiten``) takes ``total``, a function
that sums a tensor over the ranks, and sums its moments through it, so the
ranks normalise by the global batch's statistics as GSPMD's one program
does in the JAX package. Group statistics need no ``total``: a rank holds
whole prompt groups."""
from __future__ import annotations

from typing import Callable, Optional

import torch


def gae(rewards: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, *,
        gamma: float = 1.0, lam: float = 0.95):
    """Generalized advantage estimation over the response tokens: a loop
    from the last position to the first (the JAX package's reversed scan).

    rewards, values, mask (B, T). Returns (advantages (B,T), returns (B,T)).
    The sequence terminates at the last masked position; the bootstrap value
    beyond it is 0."""
    B, T = rewards.shape
    mask = mask.float()
    v_next = torch.cat([values[:, 1:], torch.zeros((B, 1), device=values.device)], dim=1) * mask
    deltas = (rewards + gamma * v_next - values) * mask
    carry = torch.zeros((B,), device=rewards.device)
    adv = [None] * T
    for t in range(T - 1, -1, -1):
        carry = deltas[:, t] + gamma * lam * mask[:, t] * carry
        adv[t] = carry
    adv = torch.stack(adv, dim=1) * mask
    return adv, adv + values * mask


def grpo(rewards: torch.Tensor, mask: torch.Tensor, *, group_size: int, eps: float = 1e-6):
    """Group-relative advantages: each sequence's reward normalised by its
    prompt group's mean and (population) std, over the response tokens."""
    B = rewards.shape[0]
    assert B % group_size == 0, (B, group_size)
    g = rewards.reshape(B // group_size, group_size)
    mean = torch.mean(g, dim=1, keepdim=True)
    std = torch.std(g, dim=1, keepdim=True, correction=0)
    adv = ((g - mean) / (std + eps)).reshape(B)
    return adv[:, None] * mask.float()


def rloo(rewards: torch.Tensor, mask: torch.Tensor, *, group_size: int):
    """Leave-one-out baseline: each rollout's baseline is the mean reward of
    the other ``group_size - 1`` members of its prompt group."""
    B = rewards.shape[0]
    assert B % group_size == 0, (B, group_size)
    assert group_size >= 2, "rloo needs >= 2 rollouts per prompt"
    g = rewards.reshape(B // group_size, group_size)
    baseline = (torch.sum(g, dim=1, keepdim=True) - g) / (group_size - 1)
    adv = (g - baseline).reshape(B)
    return adv[:, None] * mask.float()


def reinforce_pp(rewards: torch.Tensor, mask: torch.Tensor, *, eps: float = 1e-6,
                 total: Optional[Callable] = None):
    """REINFORCE++: sequence rewards normalised over the whole batch (over
    every rank's rows, summed through ``total``, where it is given)."""
    if total is None:
        mean, std = torch.mean(rewards), torch.std(rewards, correction=0)
    else:
        n = total(torch.tensor(float(rewards.numel()), device=rewards.device))
        mean = total(torch.sum(rewards)) / n
        std = torch.sqrt(total(torch.sum(torch.square(rewards - mean))) / n)
    adv = (rewards - mean) / (std + eps)
    return adv[:, None] * mask.float()


def whiten(adv: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8,
           total: Optional[Callable] = None) -> torch.Tensor:
    """Batch-whiten advantages over the masked positions (of every rank's
    rows, summed through ``total``, where it is given)."""
    total = total or (lambda t: t)
    m = mask.float()
    n = torch.clamp(total(torch.sum(m)), min=1.0)
    mean = total(torch.sum(adv * m)) / n
    var = total(torch.sum(torch.square(adv - mean) * m)) / n
    return (adv - mean) * torch.rsqrt(var + eps) * m
