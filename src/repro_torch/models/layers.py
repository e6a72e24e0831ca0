"""Shared model layers (port of ``repro.models.layers``): norms, RoPE, the MLP
flavours, and the attention projections with padded heads.

Plain functions on (params-dict, tensors), like the JAX package. Weights keep
JAX's ``(d_in, d_out)`` layout, so a layer is ``x @ W``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Params = Dict[str, Any]


def _dense_init(gen: torch.Generator, shape, *, device=None) -> torch.Tensor:
    """N(0, 1/fan_in) in fp32, stored in bf16 (``layers._dense_init``)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w / shape[0]**0.5).to(torch.bfloat16)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def init_norm(cfg: ModelConfig, *, device=None) -> Params:
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(
            "layernorm is not ported yet (ROADMAP queue 1, item 8: other families)")
    return {"w": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)}


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(
            "layernorm is not ported yet (ROADMAP queue 1, item 8: other families)")
    d = x.shape[-1]
    return ops.rmsnorm(x.reshape(-1, d), p["w"]).reshape(x.shape)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D) with positions (..., S); angles in fp32, output in
    x's dtype (``layers.rope``)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=x.device),
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# MLP flavours
# --------------------------------------------------------------------------- #
def init_mlp(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.use_bias:
        raise NotImplementedError(
            "biased layers are not ported yet (ROADMAP queue 1, item 8: other families)")
    p: Params = {"w_in": _dense_init(gen, (d, f), device=device),
                 "w_out": _dense_init(gen, (f, d), device=device)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _dense_init(gen, (d, f), device=device)
    return p


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"]
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif cfg.mlp_type == "geglu":
        # jax.nn.gelu(approximate=True) is the tanh form
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * h
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(h))
    elif cfg.mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_type)
    return h @ p["w_out"]


# --------------------------------------------------------------------------- #
# attention projections
# --------------------------------------------------------------------------- #
def init_attention(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Params:
    """Q/K/V/O projections. Q/O use padded_heads; the padded head slots of
    W_q columns and W_o rows are zero, so padded heads are exact."""
    if cfg.use_bias:
        raise NotImplementedError(
            "biased layers are not ported yet (ROADMAP queue 1, item 8: other families)")
    d, hd = cfg.d_model, cfg.head_dim
    hp, kvh = cfg.padded_heads, cfg.num_kv_heads
    wq = _dense_init(gen, (d, hp * hd), device=device)
    wk = _dense_init(gen, (d, kvh * hd), device=device)
    wv = _dense_init(gen, (d, kvh * hd), device=device)
    wo = _dense_init(gen, (hp * hd, d), device=device)
    if cfg.padded_heads != cfg.num_heads:
        wq[:, cfg.num_heads * hd:] = 0
        wo[cfg.num_heads * hd:, :] = 0
    return {"w_q": wq, "w_k": wk, "w_v": wv, "w_o": wo}


def qkv_proj(
    cfg: ModelConfig, p: Params, x: torch.Tensor, positions: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> q (B,S,Hp,hd), k/v (B,S,KVH,hd); RoPE applied if positions."""
    B, S, _ = x.shape
    hp, kvh, hd = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["w_q"]).reshape(B, S, hp, hd)
    k = (x @ p["w_k"]).reshape(B, S, kvh, hd)
    v = (x @ p["w_v"]).reshape(B, S, kvh, hd)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,Hp,hd) or (B,Hp,hd) -> (..., d)."""
    return o.reshape(*o.shape[:-2], -1) @ p["w_o"]
