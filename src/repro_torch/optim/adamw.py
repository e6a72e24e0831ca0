"""AdamW on nested params (port of ``repro.optim.adamw``).

Plain functions on tensors, as the JAX module has them. Master weights stay
in the params' own dtype (bf16 params with fp32 ``m``/``v``); grads are cast
up for the moment updates; b2 defaults to 0.95. ``torch.optim.AdamW`` is not
used: on bf16 params it keeps ``m``/``v`` in bf16.

One difference from the JAX module, for memory: :func:`update` writes the
new params, ``m`` and ``v`` into the tensors it is given and returns those
same tensors. At gemma-2b's width a second copy of them would take 26.6 GB
(5.3 GB of bf16 params and 21.3 GB of fp32 moments). The state passed in is
therefore used up; clone it first to keep it.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any
    v: Any


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree.map(zeros, params), v=tree.map(zeros, params))


@torch.no_grad()
def update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    """Returns (new_params, new_state), both holding the tensors passed in,
    updated in place. ``lr`` may be a float or a 0-d tensor (a schedule
    value computed by the caller)."""
    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()
    for g, m, v, p in zip(*(tree.leaves(t) for t in (grads, state.m, state.v, params))):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.leaves(grads)))


def clip_by_norm(grads, norm: torch.Tensor, max_norm: float):
    """``grads`` scaled by min(1, max_norm / norm), cast back to each grad's
    dtype (``norm`` given: a sharded step's norm is global over the ranks)."""
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.map(lambda g: (g.float() * scale).to(g.dtype), grads)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), cast back to each grad's
    dtype; the global norm before clipping)."""
    norm = global_norm(grads)
    return clip_by_norm(grads, norm, max_norm), norm


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, base_lr * cos)
