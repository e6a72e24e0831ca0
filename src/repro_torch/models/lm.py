"""Decoder-only LM of the PyTorch port (port of ``repro.models.lm``), dense
attention family.

Params are nested dicts like the JAX package's, with one difference: the JAX
pytree stacks each block parameter over layers, ``(N, ...)`` per pattern
position, for its ``lax.scan``; here ``params["blocks"]`` is a list with one
dict of weights per layer, and the backbone is a Python loop over it.

Two execution modes share the backbone:
  prefill  — whole prompt, emits decode caches
  decode   — one token per sequence against the caches

Caches: a list with one ``{"k", "v"}`` per layer, each (B, smax, KVH, hd).

Not ported yet: MoE, SSM/hybrid, sliding-window rings, the int8 KV cache,
chunked prefill and paged decode; each raises ``NotImplementedError`` naming
its ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

Params = Dict[str, Any]
Caches = List[Dict[str, torch.Tensor]]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of ``ModelConfig`` this slice does not port."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError("enc-dec is not ported yet (ROADMAP queue 1, item 8: other families)")
    if cfg.num_experts:
        raise NotImplementedError("MoE is not ported yet (ROADMAP queue 1, item 8: other families)")
    if cfg.ssm_state:
        raise NotImplementedError("SSM/hybrid mixers are not ported yet (ROADMAP queue 1, item 8: other families)")
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "sliding-window rings are not ported yet (ROADMAP queue 1, item 8: other families)")
    if cfg.kv_quant:
        raise NotImplementedError("the int8 KV cache is not ported yet (ROADMAP queue 1, item 7)")
    if cfg.num_prefix_embeds > 1:
        raise NotImplementedError("prefix embeds are not ported yet (ROADMAP queue 1, item 8: other families)")
    if cfg.parallel_block:
        raise NotImplementedError("parallel blocks are not ported yet (ROADMAP queue 1, item 8: other families)")


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def init(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Params:
    """Random weights by the JAX package's scheme (``lm.init``): N(0, 1/fan_in)
    projections and N(0, 0.02^2) embeddings stored in bf16, zero norm
    weights. Drawn from ``gen``, one layer after another; ``gen`` must live on
    ``device``. The numbers differ from ``jax.random``'s: use the bridge to
    run both packages on the same weights."""
    check_supported(cfg)
    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append({
            "norm1": layers.init_norm(cfg, device=device),
            "attn": layers.init_attention(cfg, gen, device=device),
            "norm2": layers.init_norm(cfg, device=device),
            "mlp": layers.init_mlp(cfg, gen, device=device),
        })
    v, d = cfg.padded_vocab, cfg.d_model
    embed = torch.randn((v, d), generator=gen, dtype=torch.float32, device=device)
    params: Params = {
        "embed": (embed * 0.02).to(torch.bfloat16),
        "blocks": blocks,
        "final_norm": layers.init_norm(cfg, device=device),
    }
    del embed
    if not cfg.tie_embeddings:
        head = torch.randn((d, v), generator=gen, dtype=torch.float32, device=device)
        params["lm_head"] = (head / (d**0.5)).to(torch.bfloat16)
    return params


# --------------------------------------------------------------------------- #
# attention mixer with cache plumbing
# --------------------------------------------------------------------------- #
def _attn_mixer(
    cfg: ModelConfig,
    p: Params,
    h: torch.Tensor,
    positions: Optional[torch.Tensor],
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]],
    cache_len: Optional[torch.Tensor],
    smax: int,
):
    if mode == "prefill":
        q, k, v = layers.qkv_proj(cfg, p, h, positions)
        o = ops.flash_attention(q, k, v, causal=True)
        B, S = h.shape[0], h.shape[1]
        if S > smax:
            raise ValueError(f"prompt of {S} tokens does not fit a cache of {smax}")
        kvh, hd = cfg.num_kv_heads, cfg.head_dim
        kc = torch.zeros((B, smax, kvh, hd), dtype=k.dtype, device=k.device)
        vc = torch.zeros((B, smax, kvh, hd), dtype=v.dtype, device=v.device)
        kc[:, :S] = k
        vc[:, :S] = v
        return layers.out_proj(cfg, p, o), {"k": kc, "v": vc}

    if mode != "decode":
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (prefill_chunk: ROADMAP queue 1, item 3; "
            "full/training: ROADMAP queue 1, item 1)")
    assert cache is not None and cache_len is not None
    B = h.shape[0]
    q, k_new, v_new = layers.qkv_proj(cfg, p, h, cache_len[:, None])
    kc, vc = cache["k"], cache["v"]
    # The new K/V row is written into the cache in place at slot cache_len.
    # The JAX package rewrites the whole cache with a masked select instead
    # (lm.py:216-219), which keeps a sequence-sharded cache in place under
    # GSPMD; PyTorch updates the one row and returns the same tensors.
    rows = torch.arange(B, device=h.device)
    kc[rows, cache_len.long()] = k_new[:, 0].to(kc.dtype)
    vc[rows, cache_len.long()] = v_new[:, 0].to(vc.dtype)
    o, _ = ops.decode_attention(q[:, 0], kc, vc, cache_len + 1)
    return layers.out_proj(cfg, p, o)[:, None], {"k": kc, "v": vc}


def _apply_block(
    cfg: ModelConfig,
    p: Params,
    h: torch.Tensor,
    positions: Optional[torch.Tensor],
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]],
    cache_len: Optional[torch.Tensor],
    smax: int,
):
    hn = layers.apply_norm(cfg, p["norm1"], h)
    mix_out, new_cache = _attn_mixer(cfg, p["attn"], hn, positions, mode, cache,
                                     cache_len, smax)
    h = h + mix_out
    hn2 = layers.apply_norm(cfg, p["norm2"], h)
    h = h + layers.apply_mlp(cfg, p["mlp"], hn2)
    return h, new_cache


def backbone(
    cfg: ModelConfig,
    params: Params,
    h: torch.Tensor,
    positions: Optional[torch.Tensor],
    *,
    mode: str,
    caches: Optional[Caches] = None,
    cache_len: Optional[torch.Tensor] = None,
    smax: int = 0,
) -> Tuple[torch.Tensor, Caches]:
    """Returns (final-normed h, new caches): a Python loop over the layers."""
    new_caches = []
    for i, block in enumerate(params["blocks"]):
        cache = None if caches is None else caches[i]
        h, c = _apply_block(cfg, block, h, positions, mode, cache, cache_len, smax)
        new_caches.append(c)
    return layers.apply_norm(cfg, params["final_norm"], h), new_caches


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    h = params["embed"][tokens.long()]
    if cfg.embed_scale:
        # a scalar in h's dtype, as lm.py:433: sqrt(2048) becomes 45.25 in bf16
        h = h * torch.tensor(cfg.d_model**0.5, dtype=h.dtype, device=h.device)
    return h


def _head_matrix(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """(d, Vp): the tied head is a transposed view of the embedding."""
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    v = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    return torch.where(v, logits, -1e30)


# --------------------------------------------------------------------------- #
# public entry points
# --------------------------------------------------------------------------- #
def init_caches(cfg: ModelConfig, batch: int, smax: int, *, device=None) -> Caches:
    """Zero bf16 caches, one ``{"k", "v"}`` (B, smax, KVH, hd) per layer."""
    check_supported(cfg)
    shape = (batch, smax, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
             "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
            for _ in range(cfg.num_layers)]


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *, smax: int):
    """Run the prompt, return (last-position logits (B, Vp) fp32, caches,
    cache_len (B,) int32)."""
    check_supported(cfg)
    h = embed_tokens(cfg, params, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, caches = backbone(cfg, params, h, positions, mode="prefill", smax=smax)
    logits = (h[:, -1] @ _head_matrix(cfg, params)).float()
    logits = mask_padded_vocab(cfg, logits)
    cache_len = torch.full((tokens.shape[0],), h.shape[1], dtype=torch.int32,
                           device=h.device)
    return logits, caches, cache_len


def _decode_hidden(cfg, params, token, caches, cache_len):
    """Shared decode-step body: embed -> backbone -> last hidden (B, d)."""
    h = embed_tokens(cfg, params, token.reshape(-1, 1))
    h, new_caches = backbone(cfg, params, h, None, mode="decode", caches=caches,
                             cache_len=cache_len)
    return h[:, 0], new_caches


def decode_step(cfg: ModelConfig, params: Params, token, caches, cache_len):
    """One decode step. Returns (logits (B, Vp) fp32, caches, cache_len + 1).
    The caches are updated in place."""
    h, new_caches = _decode_hidden(cfg, params, token, caches, cache_len)
    logits = (h @ _head_matrix(cfg, params)).float()
    return mask_padded_vocab(cfg, logits), new_caches, cache_len + 1


def decode_step_sample(
    cfg: ModelConfig,
    params: Params,
    token,
    caches,
    cache_len,
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    temperature: float,  # 0.0 = greedy
):
    """One decode step with the fused head + sampler
    (``ops.fused_sample``): the (B, Vp) logits never exist as a tensor on the
    kernel path. Returns (token (B,) int32, behaviour logprob (B,) under the
    untempered masked distribution, caches, cache_len + 1)."""
    h, new_caches = _decode_hidden(cfg, params, token, caches, cache_len)
    B = h.shape[0]
    inv_temp = torch.full((B,), 0.0 if temperature == 0.0 else 1.0 / temperature,
                          dtype=torch.float32, device=h.device)
    tok, lp = ops.fused_sample(h, _head_matrix(cfg, params), seeds, inv_temp,
                               vocab_size=cfg.vocab_size)
    return tok, lp, new_caches, cache_len + 1
