"""RL objectives (port of ``repro.rl.loss``): PPO clipped policy loss, the
KL estimators, GRPO loss, truncated importance weights, clipped value loss.

All losses are token-level means over the response mask, matching the verl /
DistFlow conventions (Fig. 1 nodes ACTOR_TRAIN / CRITIC_TRAIN).
"""
from __future__ import annotations

from typing import Dict

import torch


def _masked_mean(x, mask):
    m = mask.float()
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def ppo_policy_loss(
    logprob: torch.Tensor,  # (B,T) under the current policy
    old_logprob: torch.Tensor,  # (B,T) behaviour policy (rollout)
    advantages: torch.Tensor,  # (B,T)
    mask: torch.Tensor,  # (B,T)
    *,
    clip_eps: float = 0.2,
) -> Dict[str, torch.Tensor]:
    ratio = torch.exp(logprob - old_logprob)
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    surrogate = torch.minimum(ratio * advantages, clipped * advantages)
    loss = -_masked_mean(surrogate, mask)
    clipfrac = _masked_mean((torch.abs(ratio - 1.0) > clip_eps).float(), mask)
    approx_kl = _masked_mean(old_logprob - logprob, mask)
    return {"loss": loss, "clipfrac": clipfrac, "approx_kl": approx_kl,
            "ratio_mean": _masked_mean(ratio, mask)}


def kl_penalty(logprob, ref_logprob, mask, *, kind: str = "k3") -> torch.Tensor:
    """Per-token KL(π‖π_ref) estimator. k3 (Schulman) is low-variance and
    non-negative: exp(Δ) - Δ - 1 with Δ = ref - π."""
    delta = ref_logprob - logprob
    if kind == "k1":
        kl = -delta
    elif kind == "k2":
        kl = 0.5 * torch.square(delta)
    else:  # k3
        kl = torch.exp(delta) - delta - 1.0
    return _masked_mean(kl, mask)


def grpo_loss(logprob, old_logprob, ref_logprob, advantages, mask, *,
              clip_eps: float = 0.2, kl_coef: float = 0.001) -> Dict[str, torch.Tensor]:
    out = ppo_policy_loss(logprob, old_logprob, advantages, mask, clip_eps=clip_eps)
    kl = kl_penalty(logprob, ref_logprob, mask, kind="k3")
    out["kl"] = kl
    out["loss"] = out["loss"] + kl_coef * kl
    return out


def truncated_is_weights(
    proximal_logprob: torch.Tensor,  # (B,T) policy at batch receipt (train time)
    behavior_logprob: torch.Tensor,  # (B,T) policy that generated the batch
    mask: torch.Tensor,  # (B,T)
    *,
    rho_max: float = 2.0,
) -> Dict[str, torch.Tensor]:
    """Decoupled off-policy correction: the per-token importance ratio
    between the train-time (proximal) and the behaviour policy, truncated at
    ``rho_max``. Both inputs are data (no gradient flows through them)."""
    rho = torch.exp(proximal_logprob - behavior_logprob)
    truncated = torch.clamp(rho, max=rho_max)
    m = mask.float()
    return {
        "rho": truncated * m,
        "rho_mean": _masked_mean(truncated, mask),
        "rho_clipfrac": _masked_mean((rho > rho_max).float(), mask),
    }


def value_loss(values, old_values, returns, mask, *,
               clip_eps: float = 0.2) -> Dict[str, torch.Tensor]:
    v_clip = old_values + torch.clamp(values - old_values, -clip_eps, clip_eps)
    l1 = torch.square(values - returns)
    l2 = torch.square(v_clip - returns)
    loss = 0.5 * _masked_mean(torch.maximum(l1, l2), mask)
    return {"loss": loss, "value_err": _masked_mean(torch.abs(values - returns), mask)}
