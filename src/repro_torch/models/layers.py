"""Shared model layers (port of ``repro.models.layers``): norms, RoPE, the MLP
flavours, and the attention projections with padded heads, their optional
biases, and cross-attention over an encoder's memory.

Plain functions on (params-dict, tensors), like the JAX package. Weights keep
JAX's ``(d_in, d_out)`` layout, so a layer is ``x @ W``; a product of two
dtypes promotes both, as ``jnp.matmul`` does (an encoder's bf16 frames
against fp32 weights). Biases are fp32 and are added after a cast to the
activation's dtype, as in JAX.

On an ambient mesh with ``model`` > 1 (``distributed.constraint``) each rank
holds its ``model`` shards of the weights (``distributed.sharding``) and the
call sites of JAX's ``constrain`` become explicit collectives: ``w_q``,
``w_in`` and ``w_gate`` are column-parallel behind ``copy_to_model``,
``w_o`` and ``w_out`` row-parallel before ``reduce_from_model``, and a
row-parallel output bias is added once, after the sum. K/V come whole heads
a rank (``num_kv_heads`` divides ``model``), replicated (every rank computes
them all; ``copy_to_model`` on the whole K and V, before they are cut to
the KV heads of the local query heads, sums each head's gradient over the
ranks), or, in the serve layout, as
columns split within a head, which are all-gathered before RoPE.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import constraint as tpc
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
    """Zero weight (and, for layernorm, zero bias) in fp32."""
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)  # noqa: E731
    if cfg.norm_type == "rmsnorm":
        return {"w": zeros()}
    return {"w": zeros(), "b": zeros()}


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm through the kernel, or layernorm as plain torch (the JAX
    package computes it in jnp): ``(1 + w) * y + b`` over fp32 statistics
    with eps 1e-5, in x's dtype."""
    d = x.shape[-1]
    if cfg.norm_type == "rmsnorm":
        return ops.rmsnorm(x.reshape(-1, d), p["w"]).reshape(x.shape)
    y = F.layer_norm(x.float(), (d,), eps=1e-5)
    return ((1.0 + p["w"]) * y + p["b"]).to(x.dtype)


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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, both promoted to a common dtype first when they differ."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def _biased(cfg: ModelConfig, y: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    """``y + b`` with the fp32 bias cast to y's dtype first, where the
    config has biases."""
    return y + p[name].to(y.dtype) if cfg.use_bias else y


def _zero_bias(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=device)


# --------------------------------------------------------------------------- #
# MLP flavours
# --------------------------------------------------------------------------- #
def init_mlp(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p: Params = {"w_in": _dense_init(gen, (d, f), device=device),
                 "w_out": _dense_init(gen, (f, d), device=device)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _dense_init(gen, (d, f), device=device)
    if cfg.use_bias:
        p["b_in"] = _zero_bias(f, device)
        p["b_out"] = _zero_bias(d, device)
    return p


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    x = tpc.copy_to_model(x)  # column-parallel w_in / w_gate (JAX: constrain(h, dp, -, tp))
    h = _biased(cfg, matmul(x, p["w_in"]), p, "b_in")
    if cfg.mlp_type == "swiglu":
        h = F.silu(matmul(x, p["w_gate"])) * h
    elif cfg.mlp_type == "geglu":
        # jax.nn.gelu(approximate=True) is the tanh form
        h = F.gelu(matmul(x, p["w_gate"]), approximate="tanh") * h
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(h))
    elif cfg.mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_type)
    return _biased(cfg, tpc.reduce_from_model(matmul(h, p["w_out"])), p, "b_out")


# --------------------------------------------------------------------------- #
# attention projections
# --------------------------------------------------------------------------- #
def init_attention(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Params:
    """Q/K/V/O projections. Q/O use padded_heads; the padded head slots of
    W_q columns and W_o rows are zero, so padded heads are exact. With
    ``use_bias``, zero fp32 biases ``b_q``, ``b_k``, ``b_v``, ``b_o``. A
    decoder's cross-attention is initialised the same way."""
    d, hd = cfg.d_model, cfg.head_dim
    hp, kvh = cfg.padded_heads, cfg.num_kv_heads
    wq = _dense_init(gen, (d, hp * hd), device=device)
    wk = _dense_init(gen, (d, kvh * hd), device=device)
    wv = _dense_init(gen, (d, kvh * hd), device=device)
    wo = _dense_init(gen, (hp * hd, d), device=device)
    if cfg.padded_heads != cfg.num_heads:
        wq[:, cfg.num_heads * hd:] = 0
        wo[cfg.num_heads * hd:, :] = 0
    p: Params = {"w_q": wq, "w_k": wk, "w_v": wv, "w_o": wo}
    if cfg.use_bias:
        p.update(b_q=_zero_bias(hp * hd, device), b_k=_zero_bias(kvh * hd, device),
                 b_v=_zero_bias(kvh * hd, device), b_o=_zero_bias(d, device))
    return p


def q_proj(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> q (..., Hp * hd) (this rank's heads on a tensor-parallel
    mesh), no RoPE."""
    return _biased(cfg, matmul(tpc.copy_to_model(x), p["w_q"]), p, "b_q")


def local_heads(cfg: ModelConfig, p: Params) -> int:
    """Query heads of this rank: ``Hp / model`` on a tensor-parallel mesh."""
    return p["w_q"].shape[-1] // cfg.head_dim


def kv_heads_of(cfg: ModelConfig, hq: int) -> slice:
    """The KV heads that this rank's ``hq`` query heads attend to, among all
    ``num_kv_heads`` (GQA groups of ``Hp / num_kv_heads``). Its query heads
    must cover whole groups, or lie in one."""
    hp, kvh = cfg.padded_heads, cfg.num_kv_heads
    if hq == hp:
        return slice(0, kvh)
    g, r = hp // kvh, tpc.tp_rank()
    if hq % g and g % hq:
        raise NotImplementedError(
            f"{hq} query heads a rank over GQA groups of {g} on a mesh with model > 1 "
            "(ROADMAP queue 1, item 8: distributed)")
    lo = r * hq // g
    return slice(lo, lo + max(hq // g, 1))


def memory_kv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """K/V projections of x (B, S, d), no RoPE: an encoder memory's
    cross-attention K/V, computed once a prefill, and a decoder's own. Each
    is (B, S, heads, hd) with this rank's KV heads where the heads are
    split over ``model``, else all ``num_kv_heads``: a serve layout's
    columns within a head are all-gathered."""
    B, S, _ = x.shape
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    if p["w_k"].shape[-1] < kvh * hd:  # split over model: column-parallel
        x = tpc.copy_to_model(x)
    k = _biased(cfg, matmul(x, p["w_k"]), p, "b_k")
    v = _biased(cfg, matmul(x, p["w_v"]), p, "b_v")
    if k.shape[-1] % hd:  # the serve layout splits a head's columns
        k, v = tpc.gather_from_model(k, -1), tpc.gather_from_model(v, -1)
    return k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd)


def qkv_proj(
    cfg: ModelConfig, p: Params, x: torch.Tensor, positions: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> q (B,S,Hp,hd), k/v (B,S,KVH,hd); RoPE applied if
    positions. On a tensor-parallel mesh q holds this rank's heads and k/v
    its KV heads or all of them (:func:`memory_kv`)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = q_proj(cfg, p, x).reshape(B, S, -1, hd)
    k, v = memory_kv(cfg, p, x)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def local_kv(cfg: ModelConfig, p: Params, k: torch.Tensor, v: torch.Tensor):
    """K/V of all ``num_kv_heads`` (every rank computed or gathered them)
    cut to the heads this rank's query heads attend: the whole K and V go
    through ``copy_to_model`` first and are cut after it, so that the
    backward all-reduce over ``model`` sums each KV head's cotangent into
    that same head, whichever ranks' query heads attend it. (Cut first, the
    ranks of different GQA groups would sum the cotangents of different
    heads into one another.) K/V of this rank's heads already pass as they
    are."""
    if tpc.tp() is None or k.shape[-2] != cfg.num_kv_heads:
        return k, v
    sl = kv_heads_of(cfg, local_heads(cfg, p))
    return tpc.copy_to_model(k)[..., sl, :], tpc.copy_to_model(v)[..., sl, :]


def all_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """K/V of all ``num_kv_heads`` (what a decode cache holds on every rank):
    this rank's heads all-gathered over ``model``, or all of them as they
    are."""
    if k.shape[-2] == cfg.num_kv_heads:
        return k, v
    return tpc.gather_from_model(k, -2), tpc.gather_from_model(v, -2)


def out_proj(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,Hp,hd) or (B,Hp,hd) -> (..., d); row-parallel over ``model``
    on a tensor-parallel mesh, the bias added once after the sum."""
    y = tpc.reduce_from_model(matmul(o.reshape(*o.shape[:-2], -1), p["w_o"]))
    return _biased(cfg, y, p, "b_o")


def self_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
                   *, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention, no cache (``mode="full"``: the training and
    logprob forward), as ``layers.self_attention``."""
    q, k, v = qkv_proj(cfg, p, x, positions)
    k, v = local_kv(cfg, p, k, v)
    o = ops.flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return out_proj(cfg, p, o)


def cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    memory: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """A decoder's attention over the encoder memory's K/V (:func:`memory_kv`):
    non-causal, no RoPE, every query against every memory position. On a
    tensor-parallel mesh this rank's query heads against their KV heads."""
    B, S, _ = x.shape
    q = q_proj(cfg, p, x).reshape(B, S, -1, cfg.head_dim)
    k, v = local_kv(cfg, p, *memory)
    return out_proj(cfg, p, ops.flash_attention(q, k, v, causal=False))
