"""Decoder-only LM of the PyTorch port (port of ``repro.models.lm``): the
dense attention family (RMSNorm or layernorm, biased or not, sequential or
parallel blocks), the MoE family (``models/moe.py``, the dense dispatch),
sliding-window attention with its ring cache, the Mamba2 (SSD) family, the
hybrids that mix attention and SSD layers with dense and MoE MLPs, and
models whose input carries precomputed prefix embeddings ahead of the
tokens (a VLM's patches, ``assemble_input``). The encoder-decoder family is
``models/encdec.py``.

Params are nested dicts like the JAX package's, with one difference: the JAX
pytree stacks each block parameter over layers, ``(N, ...)`` per pattern
position, for its ``lax.scan``; here ``params["blocks"]`` is a list with one
dict of weights per layer, and the backbone is a Python loop over it.

Four execution modes share the backbone:
  full           — whole sequence, no cache (training loss, RL logprobs);
                   with ``remat`` each layer is recomputed in the backward
  prefill        — whole prompt, emits decode caches
  prefill_chunk  — one page-wide chunk of a prompt into existing caches
  decode         — one token per sequence against the caches, or (with
                   ``page_tables``) against the serving page pool

Caches: a list with one dict per layer. An attention layer holds
``{"k", "v"}``, each (B, W, KVH, hd) bf16, or with ``cfg.kv_quant`` the
int8 cache ``{"k", "v"}`` int8 with ``{"k_scale", "v_scale"}`` (B, W, KVH)
f32, one scale per slot and KV head. W is ``smax``, or with a sliding
window ``min(smax, window)``: a ring whose slot ``pos % W`` holds the
newest token of that residue. An SSD layer holds its constant-size
decode state ``{"ssm", "conv_x", "conv_bc"}``. The serving page pool is the
attention layout with pages for rows: ``init_caches(num_pages, page_size)``,
each leaf (P, page_size, KVH, hd).

``full`` mode through an SSD layer needs a sequence of at most 128
positions or a multiple of 128 (the scan's chunk), as in the JAX package:
any other length raises ``ValueError``.

**Tensor parallelism.** On an ambient mesh with ``model`` = M > 1
(``distributed.constraint``) a dense decoder runs on this rank's ``model``
shards (``distributed.sharding``: "train" for the logprob forward and the
actor step, "serve" for generation), at the call sites of JAX's
``constrain``: the attention heads and the MLP's ``d_ff`` split over the
ranks (``models/layers.py``), the embedding is looked up vocab-parallel and
summed, and the head's logits stay vocab-sharded: the log-sum-exp, the
label's logit and the entropy come from sums over ``model``, the sampler
merges the ranks' online states (``ops.fused_sample_shard``), and prefill's
logits are all-gathered. The residual stream is replicated. The decode
cache is sharded by slot as ``sharding.cache_specs`` says: rank r holds the
slots ``[r W/M, (r + 1) W/M)`` of all KV heads, its width W rounded up to a
multiple of M (the slots past W are never written or attended); a decode
step writes its token on the rank that owns its slot and attends all query
heads, gathered, over each rank's slots
(``collectives.seq_sharded_decode_attention``, or its ``_quant``
counterpart over the int8 cache), keeping its own heads of the output.
Under ``kv_quant`` prefill quantizes its slots after the KV heads are
gathered, so every scale is taken over all KV heads of its token, and a
decode step quantizes its new row once. A sliding window's ring keeps its
global width W = ``ring_width``: a step writes slot ``cache_len % W`` on the
rank that owns it and each rank attends its live slots of the
``min(cache_len + 1, W)``. ``top_p < 1`` gathers the head's logits over
``model`` and samples them with the plain sampler, as one device does.
Prefix embeddings run ahead of the tokens as on one device, replicated over
``model``. An SSD layer runs on this rank's heads and an MoE layer on this
rank's ``f`` columns of every expert (``models/ssm.py``,
``models/moe.py``); an SSD layer's decode state holds this rank's heads
(``ssm.ssm_state_shapes``). A chunk of a chunked prefill writes each of
its positions on the rank that owns its slot and attends its prefix
gathered over ``model`` (``_prefill_chunk_tp``). Paged decode raises there.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import constraint as tpc
from repro_torch.kernels import ops
from repro_torch.models import layers, moe, ssm

Params = Dict[str, Any]
Caches = List[Dict[str, torch.Tensor]]

LOSS_CHUNK = 1024  # sequence chunking for the CE/logprob head (memory bound)
IGNORE = -1  # label id excluded from the loss


# --------------------------------------------------------------------------- #
# the layer pattern (what the JAX package stacks its params by)
# --------------------------------------------------------------------------- #
def smallest_period(kinds) -> int:
    """The length of the smallest pattern that repeats to ``kinds``."""
    L = len(kinds)
    for p in range(1, L + 1):
        if L % p == 0 and all(kinds[i] == kinds[i % p] for i in range(L)):
            return p
    return L


def pattern_length(cfg: ModelConfig) -> int:
    """``lm.pattern_length``: the period of ``cfg.layer_kinds()``."""
    return smallest_period(cfg.layer_kinds())


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def _init_block(cfg: ModelConfig, gen: torch.Generator, kind, *, device=None) -> Params:
    """One layer's weights (``lm._init_block_pos``): norm1, the attention or
    SSD mixer, and the dense or MoE MLP unless the MLP kind is ``none``,
    with its own norm2 unless the block is parallel (its MLP reads norm1's
    output)."""
    mixer_kind, mlp_kind = kind
    p: Params = {"norm1": layers.init_norm(cfg, device=device)}
    if mixer_kind == "attn":
        p["attn"] = layers.init_attention(cfg, gen, device=device)
    else:
        p["ssm"] = ssm.init_ssm(cfg, gen, device=device)
    if mlp_kind != "none" and not cfg.parallel_block:
        p["norm2"] = layers.init_norm(cfg, device=device)
    if mlp_kind == "dense":
        p["mlp"] = layers.init_mlp(cfg, gen, device=device)
    elif mlp_kind == "moe":
        p["moe"] = moe.init_moe(cfg, gen, device=device)
    return p


def init(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Params:
    """Random weights by the JAX package's scheme (``lm.init``): N(0, 1/fan_in)
    projections and N(0, 0.02^2) embeddings stored in bf16, zero norm
    weights, the SSD layers' own init (``ssm.init_ssm``). Drawn from ``gen``,
    one layer after another; ``gen`` must live on ``device``. The numbers
    differ from ``jax.random``'s: use the bridge to run both packages on the
    same weights."""
    blocks = [_init_block(cfg, gen, kind, device=device) for kind in cfg.layer_kinds()]
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
# mixers with cache plumbing
# --------------------------------------------------------------------------- #
def quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., KVH, hd) -> (int8 values, f32 scales over hd), as ``lm.quant_kv``:
    scale = max(max |x|, 1e-8) / 127 in fp32, values rounded half to even and
    clipped to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequant_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(torch.bfloat16)


def ring_width(cfg: ModelConfig, smax: int) -> int:
    """Slots of an attention layer's decode cache (``lm._ring_width``):
    ``smax``, or with a sliding window at most the window."""
    if cfg.sliding_window is not None:
        return min(smax, cfg.sliding_window)
    return smax


def _attn_mixer(
    cfg: ModelConfig,
    p: Params,
    h: torch.Tensor,
    positions: Optional[torch.Tensor],
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]],
    cache_len: Optional[torch.Tensor],
    smax: int,
    chunk_offset: Optional[int] = None,
    page_tables: Optional[torch.Tensor] = None,
    write_enable: Optional[torch.Tensor] = None,
):
    if mode == "full":
        return layers.self_attention(cfg, p, h, positions), None

    if tpc.tp() is not None:
        return _attn_mixer_tp(cfg, p, h, positions, mode, cache, cache_len, smax,
                              chunk_offset)

    if mode == "prefill_chunk":
        # one chunk of a chunked prefill: write this chunk's K/V into the
        # existing cache at [offset, offset+C) in place and attend the
        # chunk's queries against the prefix [0, offset+C), as the bf16
        # branch of ``repro.models.lm._attn_mixer`` does
        assert cache is not None and chunk_offset is not None
        C = h.shape[1]
        pos = (chunk_offset + torch.arange(C, device=h.device))[None, :]
        q, k, v = layers.qkv_proj(cfg, p, h, pos)
        hi = chunk_offset + C
        kc, vc = cache["k"], cache["v"]
        if hi > kc.shape[1]:
            raise ValueError(f"chunk [{chunk_offset}, {hi}) past the cache width {kc.shape[1]}")
        if cfg.kv_quant:
            # the chunk's rows are quantized into the int8 cache in place, and
            # the chunk attends its prefix dequantized (lm.py:148-164)
            ks, vs = cache["k_scale"], cache["v_scale"]
            kc[:, chunk_offset:hi], ks[:, chunk_offset:hi] = quant_kv(k)
            vc[:, chunk_offset:hi], vs[:, chunk_offset:hi] = quant_kv(v)
            o = ops.flash_attention(q, dequant_kv(kc[:, :hi], ks[:, :hi]),
                                    dequant_kv(vc[:, :hi], vs[:, :hi]), causal=True,
                                    window=cfg.sliding_window, q_offset=chunk_offset)
            return layers.out_proj(cfg, p, o), cache
        kc[:, chunk_offset:hi] = k.to(kc.dtype)
        vc[:, chunk_offset:hi] = v.to(vc.dtype)
        o = ops.flash_attention(q, kc[:, :hi], vc[:, :hi], causal=True,
                                window=cfg.sliding_window, q_offset=chunk_offset)
        return layers.out_proj(cfg, p, o), {"k": kc, "v": vc}

    if mode == "prefill":
        q, k, v = layers.qkv_proj(cfg, p, h, positions)
        o = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
        B, S = h.shape[0], h.shape[1]
        if S > smax and cfg.sliding_window is None:
            raise ValueError(f"prompt of {S} tokens does not fit a cache of {smax}")
        W = ring_width(cfg, smax)
        kvh, hd = cfg.num_kv_heads, cfg.head_dim
        kc = torch.zeros((B, W, kvh, hd), dtype=k.dtype, device=k.device)
        vc = torch.zeros((B, W, kvh, hd), dtype=v.dtype, device=v.device)
        if S >= W:
            # a ring keeps the last W tokens at their slots pos % W
            # (lm.py:183-186); without a window this is S == smax in order
            slot = torch.arange(S - W, S, device=k.device) % W
            kc[:, slot] = k[:, S - W:]
            vc[:, slot] = v[:, S - W:]
        else:
            kc[:, :S] = k
            vc[:, :S] = v
        if cfg.kv_quant:
            # the whole zero-padded cache is quantized, as lm.py:190-194 does:
            # the rows past the prompt get values 0 and scale 1e-8 / 127
            kq, ks = quant_kv(kc)
            vq, vs = quant_kv(vc)
            return layers.out_proj(cfg, p, o), {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        return layers.out_proj(cfg, p, o), {"k": kc, "v": vc}

    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    assert cache is not None and cache_len is not None
    q, k_new, v_new = layers.qkv_proj(cfg, p, h, cache_len[:, None])
    if page_tables is not None:
        return _decode_paged(cfg, p, q, k_new, v_new, cache, cache_len, page_tables,
                             write_enable)
    if cfg.kv_quant:
        return _decode_quant(cfg, p, q, k_new, v_new, cache, cache_len)
    kc, vc = cache["k"], cache["v"]
    # The new K/V row is written into the cache in place at its slot. The
    # JAX package rewrites the whole cache with a masked select instead
    # (lm.py:216-219), which keeps a sequence-sharded cache in place under
    # GSPMD; PyTorch updates the one row and returns the same tensors.
    rows, slot, inside, kv_len, window = _write_slot(cfg, cache_len, kc.shape[1])
    kc[rows, slot] = _keep_outside(inside, k_new[:, 0].to(kc.dtype), kc[rows, slot])
    vc[rows, slot] = _keep_outside(inside, v_new[:, 0].to(vc.dtype), vc[rows, slot])
    o, _ = ops.decode_attention(q[:, 0], kc, vc, kv_len, window=window)
    return layers.out_proj(cfg, p, o)[:, None], {"k": kc, "v": vc}


def tp_cache_width(cfg: ModelConfig, smax: int) -> int:
    """Slots of this rank's share of a decode cache on a tensor-parallel
    mesh: ``ring_width`` rounded up to a multiple of ``model``, split."""
    M = tpc.tp_size()
    return -(-ring_width(cfg, smax) // M)


def _tp_prefill_slots(k: torch.Tensor, W: int, w: int) -> torch.Tensor:
    """This rank's slots ``[r w, (r + 1) w)`` of a prefill cache of ``W``
    slots, made from k (B, S, KVH, hd) of every KV head: slot s holds the
    token at position s, or in a ring that the prompt fills (S >= W) the
    one of the last W tokens with position = s mod W; the slots past the
    prompt and past W hold zeros."""
    S = k.shape[1]
    lo = tpc.tp_rank() * w
    n = max(min(w, min(S, W) - lo), 0)
    kc = k.new_zeros((k.shape[0], w) + tuple(k.shape[2:]))
    slots = torch.arange(lo, lo + n, device=k.device)
    kc[:, :n] = k[:, slots if S < W else S - W + (slots - (S - W)) % W]
    return kc


def _tp_ring_slot(cfg: ModelConfig, cache_len: torch.Tensor, w: int):
    """(the global slot a decode step writes, the live slots it attends) on a
    tensor-parallel mesh whose ranks hold ``w`` slots each. A ring's residue
    is taken modulo its global width W = ``ring_width``: with a window W is
    ``min(smax, window)``, which ``min(window, w M)`` equals wherever a
    step's position lies inside the cache (the slots that rounding W up to
    a multiple of M adds are never written or attended). Without a window
    the step writes slot ``cache_len``."""
    if cfg.sliding_window is None:
        return cache_len, cache_len + 1
    W = min(cfg.sliding_window, w * tpc.tp_size())
    return cache_len % W, torch.clamp(cache_len + 1, max=W)


def _tp_gather_slots(c: torch.Tensor) -> torch.Tensor:
    """A decode cache leaf (B, w, ...) of this rank's slots, the ranks'
    slot shards concatenated over ``model`` in slot order: (B, w M, ...)."""
    return tpc.gather_from_model(c, 1)


def _tp_chunk_span(off: int, hi: int, w: int) -> Tuple[slice, slice]:
    """(this rank's local slots, the chunk's rows) of the positions of a
    chunk ``[off, hi)`` that fall in the rank's slots ``[r w, (r + 1) w)``:
    both empty where it holds none."""
    lo = tpc.tp_rank() * w
    a = max(off, lo)
    b = max(min(hi, lo + w), a)
    return slice(a - lo, b - lo), slice(a - off, b - off)


def _prefill_chunk_tp(cfg, p, h, cache, off: int):
    """One chunk ``[off, off + C)`` of a chunked prefill on a tensor-parallel
    mesh, over the slot-sharded cache: q of this rank's query heads and K/V
    of all KV heads (``layers.all_kv``); each position written only on the
    rank that owns its slot (under ``kv_quant`` quantized once, after the KV
    heads are gathered, as prefill does); then the prefix ``[0,
    off + C)`` gathered over ``model``, dequantized under ``kv_quant``, cut
    to this rank's KV heads (``layers.local_kv``) and attended at
    ``q_offset`` = off. A chunk past the cache's global width ``w M``
    raises the ValueError of one device."""
    C = h.shape[1]
    pos = (off + torch.arange(C, device=h.device))[None, :]
    q, k, v = layers.qkv_proj(cfg, p, h, pos)
    k, v = layers.all_kv(cfg, k, v)
    hi, w = off + C, cache["k"].shape[1]
    if hi > w * tpc.tp_size():
        raise ValueError(f"chunk [{off}, {hi}) past the cache width {w * tpc.tp_size()}")
    slots, rows = _tp_chunk_span(off, hi, w)
    if cfg.kv_quant:
        for name, new in (("k", k), ("v", v)):
            cache[name][:, slots], cache[name + "_scale"][:, slots] = quant_kv(new[:, rows])
        kp, vp = (dequant_kv(_tp_gather_slots(cache[n])[:, :hi],
                             _tp_gather_slots(cache[n + "_scale"])[:, :hi]) for n in ("k", "v"))
    else:
        for name, new in (("k", k), ("v", v)):
            cache[name][:, slots] = new[:, rows].to(cache[name].dtype)
        kp, vp = (_tp_gather_slots(cache[n])[:, :hi] for n in ("k", "v"))
    # the kernel reads whole rows: the cut of the gathered heads is a strided view
    kp, vp = (t.contiguous() for t in layers.local_kv(cfg, p, kp, vp))
    o = ops.flash_attention(q, kp, vp, causal=True, window=cfg.sliding_window, q_offset=off)
    return layers.out_proj(cfg, p, o), cache


def _attn_mixer_tp(cfg, p, h, positions, mode, cache, cache_len, smax, chunk_offset):
    """The attention mixer on a tensor-parallel mesh: prefill and full mode
    attend this rank's query heads to their KV heads (under the sliding
    window); prefill writes this rank's slots of all KV heads, quantized
    after they are gathered under ``kv_quant`` (each scale over every KV
    head of its token, as on one device); a chunk of a chunked prefill as
    :func:`_prefill_chunk_tp` says; decode as the module docstring says
    (paged decode is refused before it, in :func:`_decode_hidden`)."""
    if mode == "prefill_chunk":
        assert cache is not None and chunk_offset is not None
        return _prefill_chunk_tp(cfg, p, h, cache, chunk_offset)
    if mode == "prefill":
        q, k, v = layers.qkv_proj(cfg, p, h, positions)
        kl, vl = layers.local_kv(cfg, p, k, v)
        o = ops.flash_attention(q, kl, vl, causal=True, window=cfg.sliding_window)
        S = h.shape[1]
        if S > smax and cfg.sliding_window is None:
            raise ValueError(f"prompt of {S} tokens does not fit a cache of {smax}")
        k, v = layers.all_kv(cfg, k, v)
        W, w = ring_width(cfg, smax), tp_cache_width(cfg, smax)
        kc, vc = _tp_prefill_slots(k, W, w), _tp_prefill_slots(v, W, w)
        if cfg.kv_quant:
            kq, ks = quant_kv(kc)
            vq, vs = quant_kv(vc)
            return layers.out_proj(cfg, p, o), {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        return layers.out_proj(cfg, p, o), {"k": kc, "v": vc}
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    q, k_new, v_new = layers.qkv_proj(cfg, p, h, cache_len[:, None])
    k_new, v_new = layers.all_kv(cfg, k_new, v_new)
    w = cache["k"].shape[1]
    slot, live = _tp_ring_slot(cfg, cache_len, w)
    local = slot - tpc.tp_rank() * w
    inside = (local >= 0) & (local < w)  # the rank that owns the slot writes it
    rows, local = torch.arange(cache_len.shape[0], device=h.device), local.clamp(0, w - 1).long()
    if cfg.kv_quant:
        leaves = ((cache["k"], cache["k_scale"], k_new), (cache["v"], cache["v_scale"], v_new))
        for cq, cs, new_row in leaves:
            nq, ns = quant_kv(new_row[:, 0])
            cq[rows, local] = _keep_outside(inside, nq, cq[rows, local])
            cs[rows, local] = _keep_outside(inside, ns, cs[rows, local])
    else:
        for c, new_row in ((cache["k"], k_new), (cache["v"], v_new)):
            c[rows, local] = _keep_outside(inside, new_row[:, 0].to(c.dtype), c[rows, local])
    from repro_torch.distributed import collectives

    hq = q.shape[2]
    q_all = tpc.gather_from_model(q[:, 0], -2)  # (B, Hp, hd): every query head
    if cfg.kv_quant:
        o = collectives.seq_sharded_decode_attention_quant(
            tpc.tp(), q_all, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"], live)
    else:
        o = collectives.seq_sharded_decode_attention(tpc.tp(), q_all, cache["k"], cache["v"],
                                                     live)
    o = o[:, tpc.tp_rank() * hq:(tpc.tp_rank() + 1) * hq]
    return layers.out_proj(cfg, p, o)[:, None], cache


def _write_slot(cfg: ModelConfig, cache_len: torch.Tensor, width: int):
    """(row ids, slot, inside, attended length, window) of a contiguous
    decode step (lm.py:209-229, :242-260).

    A ring (a sliding window no narrower than the cache) writes slot
    ``cache_len % width`` and attends the ``min(cache_len + 1, width)`` live
    slots without a window: they are the window, in ring order. Otherwise a
    row whose ``cache_len`` is at or past the cache width writes nothing, as
    the JAX masked select matches no slot there: its slot is clamped into
    the cache and rewritten with its own old value, so no index is out of
    range and nothing is read on the host; it attends ``cache_len + 1``
    slots under the window. ``inside`` is None where every row writes."""
    rows = torch.arange(cache_len.shape[0], device=cache_len.device)
    window = cfg.sliding_window
    if window is not None and width <= window:
        return rows, (cache_len % width).long(), None, torch.clamp(cache_len + 1, max=width), None
    return (rows, cache_len.clamp(max=width - 1).long(), cache_len < width, cache_len + 1,
            window)


def _keep_outside(inside: Optional[torch.Tensor], new: torch.Tensor,
                  old: torch.Tensor) -> torch.Tensor:
    """``new`` on the rows inside the cache, ``old`` on the others."""
    if inside is None:
        return new
    return torch.where(inside.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _decode_quant(cfg, p, q, k_new, v_new, cache, cache_len):
    """int8-cache decode step (``lm._decode_quant``): the new K/V row is
    quantized and written into the int8 cache in place at its slot (a ring's
    ``cache_len % W``), and nothing is written past the width of a cache
    that is not a ring (the JAX package rewrites the cache with a masked
    select); then the fused-dequant decode kernel attends the int8 cache: it
    stays int8 in device memory."""
    kq, vq = cache["k"], cache["v"]
    ks, vs = cache["k_scale"], cache["v_scale"]
    rows, slot, inside, kv_len, window = _write_slot(cfg, cache_len, kq.shape[1])
    for cq, cs, new_row in ((kq, ks, k_new), (vq, vs, v_new)):
        nq, ns = quant_kv(new_row[:, 0])
        cq[rows, slot] = _keep_outside(inside, nq, cq[rows, slot])
        cs[rows, slot] = _keep_outside(inside, ns, cs[rows, slot])
    o, _ = ops.decode_attention_quant(q[:, 0], kq, vq, ks, vs, kv_len, window=window)
    return layers.out_proj(cfg, p, o)[:, None], cache


def _decode_paged(cfg, p, q, k_new, v_new, cache, cache_len, page_tables, write_enable):
    """Paged decode step (``lm._decode_paged``): the cache leaves ARE the
    serving engine's page pool (P + 1, page_size, KVH, hd), and each lane's
    KV lives in the pages its ``page_tables`` row names. The new token's K/V
    is written in place into the lane's current page, and the paged
    flash-decode kernel reads the pages through the table.

    The pool's last page is a sink that no table names: lanes with
    ``write_enable`` False (retired lanes that keep stepping in the burst)
    write there. The JAX package drops those writes with an out-of-range
    index and ``mode="drop"``; on CUDA an out-of-range index is a device
    assert, and a boolean mask would cost a host sync. Full-window caches
    only: a sliding window raises, as JAX asserts (lm.py:279)."""
    if cfg.sliding_window is not None:
        raise ValueError("paged decode: sliding-window rings are not paged")
    kc, vc = cache["k"], cache["v"]
    sink, ps = kc.shape[0] - 1, kc.shape[1]
    T = page_tables.shape[1]
    pidx = torch.clamp(cache_len // ps, 0, T - 1).long()
    page = page_tables.gather(1, pidx[:, None])[:, 0].long()
    if write_enable is not None:
        page = torch.where(write_enable, page, sink)
    off = (cache_len % ps).long()
    kc[page, off] = k_new[:, 0].to(kc.dtype)
    vc[page, off] = v_new[:, 0].to(vc.dtype)
    o, _ = ops.paged_decode_attention(q[:, 0], kc, vc, page_tables, cache_len + 1)
    return layers.out_proj(cfg, p, o)[:, None], {"k": kc, "v": vc}


def _ssm_mixer(cfg: ModelConfig, p: Params, h: torch.Tensor, mode: str,
               cache: Optional[Dict[str, torch.Tensor]]):
    """The SSD mixer (``lm._ssm_mixer``): full mode (training, logprobs)
    keeps no state, prefill returns the decode state after the prompt,
    decode steps it by one token."""
    if mode == "prefill_chunk":
        raise NotImplementedError(
            "chunked prefill needs SSM state carried between chunks; "
            "use whole-prompt prefill (prefill_chunk=0) for SSM/hybrid archs")
    if mode == "full":
        return ssm.apply_ssm(cfg, p, h), None
    if mode == "prefill":
        return ssm.apply_ssm(cfg, p, h, return_state=True)
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    return ssm.apply_ssm_decode(cfg, p, h, cache)


def _apply_block(
    cfg: ModelConfig,
    p: Params,
    kind: Tuple[str, str],
    h: torch.Tensor,
    positions: Optional[torch.Tensor],
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]],
    cache_len: Optional[torch.Tensor],
    smax: int,
    chunk_offset: Optional[int] = None,
    page_tables: Optional[torch.Tensor] = None,
    write_enable: Optional[torch.Tensor] = None,
):
    """One layer of kind (mixer, mlp): pre-norm mixer and, unless the MLP
    kind is ``none``, pre-norm dense or MoE MLP, each added to the residual.
    A parallel block (``cfg.parallel_block``) feeds norm1's output to both
    and returns ``h + mix_out + mlp_out``, summed in that order as JAX does
    (bf16 sums depend on it). Returns (h, the MoE layer's aux sums
    (``moe.aux_sums``) or None, the layer's cache)."""
    mixer_kind, mlp_kind = kind
    hn = layers.apply_norm(cfg, p["norm1"], h)
    if mixer_kind == "attn":
        mix_out, new_cache = _attn_mixer(cfg, p["attn"], hn, positions, mode, cache,
                                         cache_len, smax, chunk_offset, page_tables,
                                         write_enable)
    else:
        if page_tables is not None:
            raise ValueError("paged decode: attention-only archs")
        mix_out, new_cache = _ssm_mixer(cfg, p["ssm"], hn, mode, cache)
    h = h + mix_out
    aux = None
    if mlp_kind != "none":
        hn2 = hn if cfg.parallel_block else layers.apply_norm(cfg, p["norm2"], h)
        if mlp_kind == "dense":
            h = h + layers.apply_mlp(cfg, p["mlp"], hn2)
        else:
            mlp_out, aux = moe.apply_moe_local(cfg, p["moe"], hn2)
            h = h + mlp_out
    return h, aux, new_cache


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
    chunk_offset: Optional[int] = None,
    page_tables: Optional[torch.Tensor] = None,
    write_enable: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Caches]:
    """Returns (final-normed h, the MoE layers' aux sums stacked (L_moe, 2E
    + 1) or None without MoE layers, new caches): a Python loop over the
    layers. The sums are this rank's; ``moe.aux_loss`` makes them the aux
    loss, so that no collective of it runs where nothing reads it.

    ``remat`` (when a gradient is being taken) checkpoints each layer, as
    ``jax.checkpoint`` does the JAX backbone's body: only the layer's input
    is kept, and the backward runs the layer's forward again, kernels and
    all. The final norm is not checkpointed."""
    new_caches = []
    aux = []
    for i, (block, kind) in enumerate(zip(params["blocks"], cfg.layer_kinds())):
        cache = None if caches is None else caches[i]

        def layer(h, block=block, kind=kind, cache=cache):
            return _apply_block(cfg, block, kind, h, positions, mode, cache, cache_len, smax,
                                chunk_offset, page_tables, write_enable)

        if remat and torch.is_grad_enabled():
            h, a, c = checkpoint(layer, h, use_reentrant=False, preserve_rng_state=False)
        else:
            h, a, c = layer(h)
        if a is not None:
            aux.append(a)
        new_caches.append(c)
    return (layers.apply_norm(cfg, params["final_norm"], h), torch.stack(aux) if aux else None,
            new_caches)


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``, scaled; on a tensor-parallel mesh looked up
    vocab-parallel (ids outside this rank's rows give 0) and summed over
    ``model``, then scaled."""
    embed = params["embed"]
    if tpc.tp() is None:
        h = embed[tokens.long()]
    else:
        rows = embed.shape[0]
        local = tokens.long() - tpc.tp_rank() * rows
        own = (local >= 0) & (local < rows)
        h = embed[local.clamp(0, rows - 1)]
        h = tpc.reduce_from_model(torch.where(own[..., None], h, torch.zeros_like(h)))
    if cfg.embed_scale:
        # a scalar in h's dtype, as lm.py:433: sqrt(2048) becomes 45.25 in bf16
        h = h * torch.tensor(cfg.d_model**0.5, dtype=h.dtype, device=h.device)
    return h


def assemble_input(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings, with the precomputed prefix embeddings (B, P, d)
    ahead of them when the config takes a prefix (``lm.assemble_input``)."""
    h = embed_tokens(cfg, params, tokens)
    if prefix_embeds is not None and cfg.num_prefix_embeds > 1:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    return h


def _head_matrix(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """(d, Vp): the tied head is a transposed view of the embedding. On a
    tensor-parallel mesh this rank's (d, Vp / M) vocab columns."""
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    v = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    return torch.where(v, logits, -1e30)


def head_logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits of h (..., d) over the whole padded vocab, the padded
    tail at -1e30 (all-gathered over ``model`` on a tensor-parallel mesh)."""
    logits = tpc.gather_from_model((h @ _head_matrix(cfg, params)).float(), -1)
    return mask_padded_vocab(cfg, logits)


# --------------------------------------------------------------------------- #
# chunked CE loss / logprobs (never materialises (B, S, V) at once)
# --------------------------------------------------------------------------- #
def _head_chunk(hx, w_head, lx, vocab_size: Optional[int]):
    """One chunk of the head: (logprob of the labels, entropy), each (B, C),
    over fp32 logits with the padded vocab at -1e30 (as sampling masks it)."""
    logits = (hx @ w_head).float()  # (B, C, Vp)
    if vocab_size is not None and vocab_size < w_head.shape[1]:
        live = torch.arange(w_head.shape[1], device=logits.device) < vocab_size
        logits = torch.where(live, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    tok = logits.gather(-1, lx.clamp(min=0).long()[..., None])[..., 0]
    probs = torch.softmax(logits, dim=-1)
    entropy = logz - torch.sum(probs * logits, dim=-1)
    return tok - logz, entropy


def _head_chunk_tp(hx, w_head, lx, vocab_size: Optional[int]):
    """:func:`_head_chunk` over this rank's vocab columns on a
    tensor-parallel mesh: the padded tail masked by global index, ``logz``
    the max over ``model`` plus the log of the summed exp, the label's logit
    from the rank that owns it, and the entropy ``logz - sum(e z) / sum(e)``
    (all sums over ``model``). The max is held constant, as it cancels."""
    logits = (hx @ w_head).float()  # (B, C, Vp / M)
    V = w_head.shape[1]
    off = tpc.tp_rank() * V
    if vocab_size is not None:
        live = torch.arange(off, off + V, device=logits.device) < vocab_size
        logits = torch.where(live, logits, -1e30)
    m = tpc.max_over_model(logits.detach().amax(dim=-1))
    e = torch.exp(logits - m[..., None])
    total = tpc.reduce_from_model(e.sum(dim=-1))
    moment = tpc.reduce_from_model(torch.sum(e * logits, dim=-1))
    logz = m + torch.log(total)
    local = lx.clamp(min=0).long() - off
    own = (local >= 0) & (local < V)
    tok = logits.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0]
    tok = tpc.reduce_from_model(torch.where(own, tok, torch.zeros_like(tok)))
    return tok - logz, logz - moment / total


def _chunked_head_scan(h, w_head, labels, chunk: int, vocab_size: Optional[int] = None):
    """Per-position (logprob, entropy, mask) over sequence chunks of ``chunk``
    positions (``lm._chunked_head_scan``). When a gradient is being taken each
    chunk is checkpointed, as the JAX scan body is: its (B, C, Vp) fp32
    logits are made again in the backward instead of kept."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=IGNORE)
    body = _head_chunk
    if tpc.tp() is not None:  # vocab-parallel head behind copy_to_model
        body, h = _head_chunk_tp, tpc.copy_to_model(h)
    lps, ents = [], []
    for i in range(0, h.shape[1], chunk):
        hx, lx = h[:, i:i + chunk], labels[:, i:i + chunk]
        if torch.is_grad_enabled() and (hx.requires_grad or w_head.requires_grad):
            lp, ent = checkpoint(body, hx, w_head, lx, vocab_size,
                                 use_reentrant=False, preserve_rng_state=False)
        else:
            lp, ent = body(hx, w_head, lx, vocab_size)
        lps.append(lp)
        ents.append(ent)
    return (torch.cat(lps, dim=1)[:, :S], torch.cat(ents, dim=1)[:, :S],
            (labels != IGNORE)[:, :S])


def token_stats(cfg: ModelConfig, params: Params, h, labels, chunk: int = LOSS_CHUNK):
    return _chunked_head_scan(h, _head_matrix(cfg, params), labels, chunk,
                              vocab_size=cfg.vocab_size)


def ce_loss(cfg: ModelConfig, params: Params, h, labels):
    lp, ent, mask = token_stats(cfg, params, h, labels)
    denom = torch.clamp(mask.sum(), min=1)
    loss = -torch.sum(lp * mask) / denom
    return loss, {"ce": loss, "entropy": torch.sum(ent * mask) / denom}


def _full_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor, remat: bool,
                 prefix_embeds: Optional[torch.Tensor] = None):
    """(final-normed h, the MoE layers' aux sums or None) of ``full``
    mode, over the prefix (if any) and the tokens."""
    h = assemble_input(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, aux, _ = backbone(cfg, params, h, positions, mode="full", remat=remat)
    return h, aux


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat: bool = True):
    """LM training loss (``lm.loss_fn``): batch tokens (B, S), optional
    ``prefix_embeds`` (B, P, d), and labels (B, P + S) with ``IGNORE`` at
    positions not predicted. Returns (loss, {"ce", "entropy"}); with MoE
    layers the loss adds 0.01 x the aux loss summed over the layers, its
    token means over the global batch (``moe.aux_loss``), reported as
    ``"moe_aux"``."""
    h, sums = _full_hidden(cfg, params, batch["tokens"], remat, batch.get("prefix_embeds"))
    loss, metrics = ce_loss(cfg, params, h, batch["labels"])
    if cfg.num_experts:
        aux = (moe.aux_loss(cfg, sums) if sums is not None
               else torch.zeros((), dtype=torch.float32, device=h.device))
        loss = loss + 0.01 * aux
        metrics["moe_aux"] = aux
    return loss, metrics


def logprobs_fn(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                prefix_embeds: Optional[torch.Tensor] = None, remat: bool = False):
    """Per-token logprob and entropy of ``tokens`` under the model
    (``lm.logprobs_fn``): (B, S) each, position i scoring tokens[:, i] given
    the prefix and tokens[:, :i]; position 0 gets 0. The MoE aux loss is
    dropped, as in JAX."""
    h, _ = _full_hidden(cfg, params, tokens, remat, prefix_embeds)
    off = h.shape[1] - tokens.shape[1]  # the prefix's length
    lp, ent, _ = token_stats(cfg, params, h[:, off:off + tokens.shape[1] - 1], tokens[:, 1:])
    zero = torch.zeros((tokens.shape[0], 1), dtype=lp.dtype, device=lp.device)
    return torch.cat([zero, lp], dim=1), torch.cat([zero, ent], dim=1)


# --------------------------------------------------------------------------- #
# public entry points
# --------------------------------------------------------------------------- #
def init_caches(cfg: ModelConfig, batch: int, smax: int, *, device=None) -> Caches:
    """Zero caches, one dict per layer (``lm.init_caches``): an attention
    layer's ``{"k", "v"}`` (B, W, KVH, hd) bf16 with W = ``ring_width``, or
    int8 with f32 ``{"k_scale", "v_scale"}`` (B, W, KVH) under ``kv_quant``;
    an SSD layer's ``{"ssm", "conv_x", "conv_bc"}`` state (this rank's heads
    on a tensor-parallel mesh)."""
    width = ring_width(cfg, smax) if tpc.tp() is None else tp_cache_width(cfg, smax)
    shape = (batch, width, cfg.num_kv_heads, cfg.head_dim)

    def zeros(shape_, dtype):
        return torch.zeros(shape_, dtype=dtype, device=device)

    caches = []
    for mixer_kind, _ in cfg.layer_kinds():
        if mixer_kind != "attn":
            caches.append({name: zeros(sh, dt)
                           for name, (sh, dt) in ssm.ssm_state_shapes(cfg, batch).items()})
        elif cfg.kv_quant:
            caches.append({"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                           "k_scale": zeros(shape[:3], torch.float32),
                           "v_scale": zeros(shape[:3], torch.float32)})
        else:
            caches.append({"k": zeros(shape, torch.bfloat16), "v": zeros(shape, torch.bfloat16)})
    return caches


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *, smax: int,
            prefix_embeds: Optional[torch.Tensor] = None):
    """Run the prefix (if any) and the prompt, return (last-position logits
    (B, Vp) fp32, caches, cache_len (B,) int32: the positions run)."""
    h = assemble_input(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, _, caches = backbone(cfg, params, h, positions, mode="prefill", smax=smax)
    logits = head_logits(cfg, params, h[:, -1])
    cache_len = torch.full((tokens.shape[0],), h.shape[1], dtype=torch.int32,
                           device=h.device)
    return logits, caches, cache_len


def _decode_hidden(cfg, params, token, caches, cache_len, page_tables=None,
                   write_enable=None):
    """Shared decode-step body: embed -> backbone -> last hidden (B, d).
    With ``page_tables``, ``caches`` is the serving page pool and attention
    runs through the block table (see :func:`_decode_paged`), on one device
    only: a tensor-parallel mesh refuses it before the embedding's
    collective."""
    if page_tables is not None:
        tpc.require_dense("paged decode")
    h = embed_tokens(cfg, params, token.reshape(-1, 1))
    h, _, new_caches = backbone(cfg, params, h, None, mode="decode", caches=caches,
                             cache_len=cache_len, page_tables=page_tables,
                             write_enable=write_enable)
    return h[:, 0], new_caches


def decode_step(cfg: ModelConfig, params: Params, token, caches, cache_len):
    """One decode step. Returns (logits (B, Vp) fp32, caches, cache_len + 1).
    The caches are updated in place."""
    h, new_caches = _decode_hidden(cfg, params, token, caches, cache_len)
    return head_logits(cfg, params, h), new_caches, cache_len + 1


def decode_step_sample(
    cfg: ModelConfig,
    params: Params,
    token,
    caches,
    cache_len,
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    temperature: float,  # 0.0 = greedy
    *,
    top_p: float = 1.0,  # < 1 takes the plain sampler, as in JAX
):
    """One decode step with the fused head + sampler
    (``ops.fused_sample``): the (B, Vp) logits never exist as a tensor on the
    kernel path. Returns (token (B,) int32, behaviour logprob (B,) under the
    untempered masked distribution, caches, cache_len + 1)."""
    h, new_caches = _decode_hidden(cfg, params, token, caches, cache_len)
    B = h.shape[0]
    inv_temp = torch.full((B,), 0.0 if temperature == 0.0 else 1.0 / temperature,
                          dtype=torch.float32, device=h.device)
    head = _head_matrix(cfg, params)
    if tpc.tp() is not None and top_p < 1.0:
        # the nucleus needs the whole sorted distribution: the ranks' fp32
        # logits gathered over model, then the plain sampler one device takes
        z = tpc.gather_from_model(h.float() @ head.float(), -1)
        tok, lp = ops.sample_logits(z, seeds, inv_temp, vocab_size=cfg.vocab_size, top_p=top_p)
        return tok, lp, new_caches, cache_len + 1
    if tpc.tp() is not None:  # the ranks' online states over their vocab columns
        tok, lp = ops.fused_sample_shard(tpc.tp(), h, head, seeds, inv_temp,
                                         vocab_size=cfg.vocab_size,
                                         col_offset=tpc.tp_rank() * head.shape[1])
        return tok, lp, new_caches, cache_len + 1
    tok, lp = ops.fused_sample(h, head, seeds, inv_temp, vocab_size=cfg.vocab_size,
                               top_p=top_p)
    return tok, lp, new_caches, cache_len + 1


def decode_step_paged(cfg: ModelConfig, params: Params, token, pool, cache_len,
                      page_tables, *, write_enable=None):
    """Paged decode step over the serving page pool (updated in place).
    Returns (logits (B, Vp) fp32, pool, cache_len + 1)."""
    h, new_pool = _decode_hidden(cfg, params, token, pool, cache_len, page_tables,
                                 write_enable)
    return head_logits(cfg, params, h), new_pool, cache_len + 1


def decode_step_paged_sample(
    cfg: ModelConfig,
    params: Params,
    token,
    pool,
    cache_len,
    page_tables,  # (B, T) int32
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    temps: torch.Tensor,  # (B,) f32; <= 0 means greedy
    *,
    write_enable=None,
):
    """Paged decode + fused per-row sampling (the serving burst step).
    Returns (sampled token (B,) int32, pool, cache_len + 1)."""
    h, new_pool = _decode_hidden(cfg, params, token, pool, cache_len, page_tables,
                                 write_enable)
    tok = ops.fused_sample_rows(h, _head_matrix(cfg, params), seeds, temps,
                                vocab_size=cfg.vocab_size)
    return tok, new_pool, cache_len + 1


def prefill_chunk(cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches, *,
                  offset: int):
    """One chunk of a chunked prefill into existing caches (``lm.prefill_chunk``):
    chunk tokens (B, C) write their K/V into ``caches`` at [offset, offset+C)
    in place and attend the prefix [0, offset+C). Over consecutive chunks it
    computes what one whole-prompt :func:`prefill` does, up to float
    reassociation; with ``kv_quant`` the chunk attends its prefix quantized
    and dequantized, which whole-prompt prefill never does. SSD layers raise
    (their state would have to carry between chunks). Returns (last-position logits (B, Vp) fp32, caches); the
    caller owns ``cache_len``."""
    h = embed_tokens(cfg, params, tokens)
    h, _, new_caches = backbone(cfg, params, h, None, mode="prefill_chunk", caches=caches,
                             chunk_offset=offset)
    return head_logits(cfg, params, h[:, -1]), new_caches


# --------------------------------------------------------------------------- #
# cache rows and pages (the serving arena's copies)
# --------------------------------------------------------------------------- #
def _index(caches: Caches, slots):
    """(positions in ``slots`` whose id is a row of ``caches``, those ids),
    as long tensors on the caches' device: out-of-range slot ids are
    dropped, as ``mode="drop"`` does in the JAX package. The batch size is
    dimension 0 of any leaf, an attention layer's K/V or an SSD layer's
    state alike."""
    leaf = next(iter(caches[0].values()))
    ids = [int(s) for s in slots]
    keep = [j for j, s in enumerate(ids) if 0 <= s < leaf.shape[0]]
    as_t = lambda xs: torch.tensor(xs, dtype=torch.long, device=leaf.device)  # noqa: E731
    return as_t(keep), as_t([ids[j] for j in keep])


def _attention_only(caches: Caches) -> None:
    """The page helpers move token spans: raise for a layer without one."""
    for c in caches:
        if "k" not in c:
            raise ValueError(
                f"cache pages are spans of the token axis, which attention caches have; "
                f"a layer with leaves {sorted(c)} (SSM state) has none to page")


def gather_cache_rows(caches: Caches, slots) -> Caches:
    """The cache rows at ``slots`` (a new tensor per leaf, SSM state too)."""
    _, idx = _index(caches, slots)
    return [{name: leaf[idx] for name, leaf in c.items()} for c in caches]


def scatter_cache_rows(caches: Caches, rows: Caches, slots) -> Caches:
    """Overwrite the cache rows at ``slots`` with ``rows`` in place, every
    leaf; out-of-range slot ids are dropped. Returns ``caches``."""
    keep, ids = _index(caches, slots)
    for c, r in zip(caches, rows):
        for name, leaf in c.items():
            leaf[ids] = r[name][keep].to(leaf.dtype)
    return caches


def gather_cache_pages(caches: Caches, slots, *, num_pages: int, page_size: int) -> Caches:
    """The first ``num_pages`` pages (``page_size``-token spans) of the rows
    at ``slots``: leaves shaped (R, num_pages, page_size, KVH, hd).
    Attention caches only: raises ValueError on SSM state."""
    _attention_only(caches)
    span = num_pages * page_size
    _, idx = _index(caches, slots)
    return [{name: leaf[idx, :span].reshape((len(idx), num_pages, page_size)
                                            + tuple(leaf.shape[2:]))
             for name, leaf in c.items()} for c in caches]


def scatter_cache_pages(caches: Caches, pages: Caches, slots) -> Caches:
    """Inverse of :func:`gather_cache_pages`: write page stacks (leaves
    (R, k, page_size, ...)) contiguously into the rows at ``slots``, over
    positions [0, k * page_size), in place; out-of-range slot ids are
    dropped. Attention caches only, as :func:`gather_cache_pages`. Returns
    ``caches``."""
    _attention_only(caches)
    keep, ids = _index(caches, slots)
    for c, pg in zip(caches, pages):
        for name, leaf in c.items():
            p = pg[name][keep]
            span = p.shape[1] * p.shape[2]
            leaf[ids, :span] = p.reshape((len(ids), span) + tuple(p.shape[3:])).to(leaf.dtype)
    return caches
