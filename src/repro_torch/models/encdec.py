"""Encoder-decoder backbone of the PyTorch port (port of
``repro.models.encdec``, seamless-m4t): a bidirectional encoder over
precomputed frame embeddings (the speech frontend is a stub, as in the JAX
package) and a causal decoder with cross-attention over the encoder's
memory.

Params: ``{"encoder": [one dict a layer], "decoder": [one dict a layer],
"enc_norm", "final_norm", "embed"[, "lm_head"]}``. The JAX pytree stacks
each stack's leaves over its layers, (L, ...); here each stack is a list,
and the bridge converts.

Caches: a list with one dict per decoder layer, ``{"k", "v"}`` the
self-attention cache (B, smax, KVH, hd) and ``{"mk", "mv"}`` the
cross-attention K/V of the memory (B, S_enc, KVH, hd), computed once by
:func:`prefill`. A decode step attends the whole memory, ``enc_valid =
cfg.encoder_len`` positions, through ``decode_attention``, as JAX does.

There is no fused sampler, no paged decode and no chunked prefill for this
family (``models/api.py`` raises JAX's exceptions): a caller serves it
through :func:`prefill` and :func:`decode_step` and samples from the logits
itself.

**Tensor parallelism.** On an ambient mesh with ``model`` = M > 1
(``distributed.constraint``) both stacks run on this rank's ``model``
shards as the decoder-only LM does (``models/lm.py``): the encoder's
non-causal self-attention, the decoder's self- and cross-attention on this
rank's query heads, the MLPs by ``d_ff``, the embedding and the head
vocab-parallel (the loss's and logprobs' log-sum-exp summed over
``model``, prefill's and a decode step's logits all-gathered). The
self-attention cache is split by slot, as ``lm`` splits it. The memory's
``{"mk", "mv"}`` hold this rank's KV heads, as :func:`layers.memory_kv`
computes them (all of them where the KV heads do not split over M): each
rank's cross-attention then reads only its own heads, written once a
prefill, and a decode step makes no collective for it. JAX's
``sharding.cache_specs`` splits ``mk``/``mv`` by sequence instead; that is
a layout for GSPMD, which would attend the slot shards and merge them with
two more collectives a layer and a step, and the port does not take it.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import constraint as tpc
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.lm import (
    Caches,
    _attn_mixer,
    ce_loss,
    embed_tokens,
    head_logits,
    ring_width,
    token_stats,
    tp_cache_width,
)

Params = Dict[str, Any]


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    return {"norm1": layers.init_norm(cfg, device=device),
            "attn": layers.init_attention(cfg, gen, device=device),
            "norm2": layers.init_norm(cfg, device=device),
            "mlp": layers.init_mlp(cfg, gen, device=device)}


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    return {"norm1": layers.init_norm(cfg, device=device),
            "self_attn": layers.init_attention(cfg, gen, device=device),
            "norm_x": layers.init_norm(cfg, device=device),
            "cross_attn": layers.init_attention(cfg, gen, device=device),
            "norm2": layers.init_norm(cfg, device=device),
            "mlp": layers.init_mlp(cfg, gen, device=device)}


def init(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Params:
    """Random weights by the JAX package's scheme (``encdec.init``), drawn
    from ``gen`` on ``device``: the encoder's layers, the decoder's, the
    embedding, then the untied head. The numbers differ from
    ``jax.random``'s: use the bridge to run both packages on the same
    weights."""
    params: Params = {
        "encoder": [_init_enc_layer(cfg, gen, device) for _ in range(cfg.num_encoder_layers)],
        "decoder": [_init_dec_layer(cfg, gen, device) for _ in range(cfg.num_layers)],
        "enc_norm": layers.init_norm(cfg, device=device),
        "final_norm": layers.init_norm(cfg, device=device),
    }
    v, d = cfg.padded_vocab, cfg.d_model
    embed = torch.randn((v, d), generator=gen, dtype=torch.float32, device=device)
    params["embed"] = (embed * 0.02).to(torch.bfloat16)
    del embed
    if not cfg.tie_embeddings:
        head = torch.randn((d, v), generator=gen, dtype=torch.float32, device=device)
        params["lm_head"] = (head / (d**0.5)).to(torch.bfloat16)
    return params


def _stack(layer_fn, h: torch.Tensor, stack: List[Params], remat: bool) -> torch.Tensor:
    """``layer_fn(h, p)`` over the layers of a stack; with ``remat`` (when a
    gradient is being taken) each layer is checkpointed, as
    ``jax.checkpoint`` does the JAX scan's body."""
    for p in stack:
        if remat and torch.is_grad_enabled():
            h = checkpoint(layer_fn, h, p, use_reentrant=False, preserve_rng_state=False)
        else:
            h = layer_fn(h, p)
    return h


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames (B, S_enc, d), precomputed embeddings (cast to bf16, as JAX
    does) -> the memory (B, S_enc, d): non-causal self-attention with RoPE,
    then the MLP, pre-norm, and the encoder's final norm."""
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]

    def layer(h, p):
        hn = layers.apply_norm(cfg, p["norm1"], h)
        h = h + layers.self_attention(cfg, p["attn"], hn, positions, causal=False)
        return h + layers.apply_mlp(cfg, p["mlp"], layers.apply_norm(cfg, p["norm2"], h))

    h = _stack(layer, frames.to(torch.bfloat16), params["encoder"], remat)
    return layers.apply_norm(cfg, params["enc_norm"], h)


def _cross_and_mlp(cfg: ModelConfig, p: Params, h: torch.Tensor, memory_kv) -> torch.Tensor:
    """The second half of a decoder layer: cross-attention over the memory's
    K/V, then the MLP, each pre-norm and added to the residual."""
    hx = layers.apply_norm(cfg, p["norm_x"], h)
    h = h + layers.cross_attention(cfg, p["cross_attn"], hx, memory_kv)
    return h + layers.apply_mlp(cfg, p["mlp"], layers.apply_norm(cfg, p["norm2"], h))


def decode_full(cfg: ModelConfig, params: Params, tokens: torch.Tensor, memory: torch.Tensor,
                *, remat: bool = False) -> torch.Tensor:
    """The teacher-forced decoder over ``tokens`` (B, S_dec) -> final-normed
    hidden states (B, S_dec, d)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]

    def layer(h, p):
        hn = layers.apply_norm(cfg, p["norm1"], h)
        h = h + layers.self_attention(cfg, p["self_attn"], hn, positions, causal=True)
        return _cross_and_mlp(cfg, p, h, layers.memory_kv(cfg, p["cross_attn"], memory))

    h = _stack(layer, embed_tokens(cfg, params, tokens), params["decoder"], remat)
    return layers.apply_norm(cfg, params["final_norm"], h)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat: bool = True):
    """batch: frames (B, S_enc, d), tokens (B, S_dec), labels (B, S_dec) with
    ``IGNORE`` at positions not predicted. Returns (loss, {"ce",
    "entropy"})."""
    memory = encode(cfg, params, batch["frames"], remat=remat)
    h = decode_full(cfg, params, batch["tokens"], memory, remat=remat)
    return ce_loss(cfg, params, h, batch["labels"])


def logprobs_fn(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                frames: torch.Tensor, *, remat: bool = False):
    """(logprob, entropy) of ``tokens`` given ``frames``, each (B, S);
    position 0 gets 0."""
    memory = encode(cfg, params, frames, remat=remat)
    h = decode_full(cfg, params, tokens, memory, remat=remat)
    lp, ent, _ = token_stats(cfg, params, h[:, :-1], tokens[:, 1:])
    zero = torch.zeros((tokens.shape[0], 1), dtype=lp.dtype, device=lp.device)
    return torch.cat([zero, lp], dim=1), torch.cat([zero, ent], dim=1)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, frames: torch.Tensor,
            *, smax: int):
    """Encode ``frames``, run the decoder over the prompt ``tokens`` (B, S)
    and emit the decode caches. Returns (last-position logits (B, Vp) fp32,
    caches, cache_len (B,) int32 = S)."""
    memory = encode(cfg, params, frames)
    B, S = tokens.shape
    h = embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None, :]
    caches = []
    for p in params["decoder"]:
        hn = layers.apply_norm(cfg, p["norm1"], h)
        out, kv = _attn_mixer(cfg, p["self_attn"], hn, positions, "prefill", None, None, smax)
        h = h + out
        mk, mv = layers.memory_kv(cfg, p["cross_attn"], memory)
        h = _cross_and_mlp(cfg, p, h, (mk, mv))
        caches.append({**kv, "mk": mk, "mv": mv})
    h = layers.apply_norm(cfg, params["final_norm"], h)
    logits = head_logits(cfg, params, h[:, -1])
    return logits, caches, torch.full((B,), S, dtype=torch.int32, device=tokens.device)


def init_caches(cfg: ModelConfig, batch: int, smax: int, *, device=None) -> Caches:
    """Zero bf16 caches (``encdec.init_caches``): per decoder layer the
    self-attention ``{"k", "v"}`` (B, smax, KVH, hd) and the memory's
    ``{"mk", "mv"}`` (B, encoder_len, KVH, hd). On a tensor-parallel mesh
    the self-attention cache holds this rank's slots of all KV heads and the
    memory this rank's KV heads (all of them where they do not split over
    ``model``), as :func:`prefill` makes them."""
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    width, mem_kvh = ring_width(cfg, smax), kvh
    if tpc.tp() is not None:
        width = tp_cache_width(cfg, smax)
        mem_kvh = kvh // tpc.tp_size() if kvh % tpc.tp_size() == 0 else kvh

    def zeros(width, heads):
        return torch.zeros((batch, width, heads, hd), dtype=torch.bfloat16, device=device)

    return [{"k": zeros(width, kvh), "v": zeros(width, kvh),
             "mk": zeros(cfg.encoder_len, mem_kvh), "mv": zeros(cfg.encoder_len, mem_kvh)}
            for _ in range(cfg.num_layers)]


def decode_step(cfg: ModelConfig, params: Params, token, caches: Caches,
                cache_len: torch.Tensor):
    """One decoder token against its self-attention cache (written in place
    at ``cache_len``) and the fixed memory K/V. Returns (logits (B, Vp)
    fp32, caches, cache_len + 1)."""
    h = embed_tokens(cfg, params, token.reshape(-1, 1))
    B = h.shape[0]
    enc_valid = torch.full((B,), cfg.encoder_len, dtype=torch.int32, device=h.device)
    new_caches = []
    for p, c in zip(params["decoder"], caches):
        hn = layers.apply_norm(cfg, p["norm1"], h)
        out, kv = _attn_mixer(cfg, p["self_attn"], hn, None, "decode", c, cache_len, 0)
        h = h + out
        hx = layers.apply_norm(cfg, p["norm_x"], h)
        # this rank's query heads against their KV heads of the memory
        q = layers.q_proj(cfg, p["cross_attn"], hx).reshape(B, -1, cfg.head_dim)
        mk, mv = layers.local_kv(cfg, p["cross_attn"], c["mk"], c["mv"])
        o, _ = ops.decode_attention(q, mk, mv, enc_valid)
        h = h + layers.out_proj(cfg, p["cross_attn"], o)[:, None]
        h = h + layers.apply_mlp(cfg, p["mlp"], layers.apply_norm(cfg, p["norm2"], h))
        new_caches.append({**kv, "mk": c["mk"], "mv": c["mv"]})
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return head_logits(cfg, params, h[:, 0]), new_caches, cache_len + 1
