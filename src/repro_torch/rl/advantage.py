"""Advantage estimators (port of ``repro.rl.advantage``): GAE (PPO),
group-relative (GRPO), leave-one-out (RLOO) and global-batch-normalised
(REINFORCE++), plus masked whitening."""
from __future__ import annotations

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


def reinforce_pp(rewards: torch.Tensor, mask: torch.Tensor, *, eps: float = 1e-6):
    """REINFORCE++: sequence rewards normalised over the whole batch."""
    adv = (rewards - torch.mean(rewards)) / (torch.std(rewards, correction=0) + eps)
    return adv[:, None] * mask.float()


def whiten(adv: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Batch-whiten advantages over the masked positions."""
    m = mask.float()
    n = torch.clamp(torch.sum(m), min=1.0)
    mean = torch.sum(adv * m) / n
    var = torch.sum(torch.square(adv - mean) * m) / n
    return (adv - mean) * torch.rsqrt(var + eps) * m
