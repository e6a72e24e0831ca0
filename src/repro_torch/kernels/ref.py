"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, on any device, with
ordinary tensor ops. The CPU tests hold them against the JAX package
(``repro.kernels.ref`` and the Pallas kernels in interpret mode), and
``chip_smoke.py`` holds each kernel against them on the card.

Shapes (the JAX package's conventions, kept at every public function):
  q              (B, S, H, D)
  k, v           (B, S, KVH, D)      KVH | H  (GQA groups = H // KVH)
  decode q       (B, H, D)           single new token per sequence
  page pool      (P, page_size, KVH, D)
  ssd x          (B, S, NH, P)       dt (B, S, NH); A, D (NH,)
  ssd Bm, Cm     (B, S, G, N)        NH heads in G groups; state (B, NH, P, N)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_U32 = 0xFFFFFFFF


def _up(t: torch.Tensor) -> torch.Tensor:
    """fp32 for the working types, float64 kept (for ``gradcheck``)."""
    return t if t.dtype == torch.float64 else t.float()


def vjp(fn, inputs, cotangent, needs=None, **kw):
    """The VJP of the plain version ``fn`` at ``inputs`` against the output
    ``cotangent``, by autograd through ``fn(*inputs, **kw)``: one gradient
    per input, ``None`` where ``needs`` says no. Where ``fn`` returns a
    tuple, ``cotangent`` is a tuple too: an output whose cotangent is
    ``None`` is left out, and an input that the other outputs do not reach
    gets ``None`` (a single output must reach every input that needs a
    gradient). The backward of the kernels that have one (their autograd
    Functions)."""
    needs = needs or (True,) * len(inputs)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = fn(*ins, **kw)
        several = isinstance(out, tuple)
        if several:  # the outputs that have a cotangent
            pairs = [(o, c) for o, c in zip(out, cotangent) if c is not None]
            if not pairs:
                return (None,) * len(needs)
            out, cotangent = zip(*pairs)
        got = iter(torch.autograd.grad(out, [t for t, n in zip(ins, needs) if n], cotangent,
                                       allow_unused=several))
    return tuple(next(got) if n else None for n in needs)


# --------------------------------------------------------------------------- #
# rmsnorm
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in fp32 (float64 stays
    float64), output in x's dtype."""
    xf = _up(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + _up(w))).to(x.dtype)


def rmsnorm_sumsq(x: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of ``x^2`` over the last dim (float64 stays float64): a
    row's share of the mean square of a width split over ranks."""
    xf = _up(x)
    return torch.sum(xf * xf, dim=-1)


def rmsnorm_scaled(x: torch.Tensor, ss: torch.Tensor, w: torch.Tensor, *, width: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` of the columns ``x`` (..., D) of rows ``width`` wide,
    from the rows' whole sums of squares ``ss`` (...): ``x * rsqrt(ss / width
    + eps) * (1 + w)`` in fp32, output in x's dtype."""
    y = _up(x) * torch.rsqrt(_up(ss)[..., None] / width + eps)
    return (y * (1.0 + _up(w))).to(x.dtype)


# --------------------------------------------------------------------------- #
# attention (prefill)
# --------------------------------------------------------------------------- #
def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full masked attention, grouped over GQA heads (k/v never repeated).

    ``q_offset``: absolute position of q[0]; ``window``: position i attends
    to [i-window+1, i]. Logits are the fp32 sum of the inputs' products and
    the probabilities are rounded to v's dtype before the value product, as
    in the JAX package.
    """
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    scale = scale if scale is not None else 1.0 / (D**0.5)
    qg = q.reshape(B, Sq, KVH, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", _up(qg), _up(k)) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D).to(q.dtype)


# --------------------------------------------------------------------------- #
# decode attention (one new token vs a KV cache)
# --------------------------------------------------------------------------- #
def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    pos_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token attention against a partly filled cache.

    q (B,H,D); k,v (B,S,KVH,D); cache_len (B,) int32 valid slots.
    ``pos_offset`` is the absolute position of cache slot 0. Returns
    (o (B,H,D) in q's dtype, lse (B,H) fp32).
    """
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    scale = scale if scale is not None else 1.0 / (D**0.5)
    qg = q.reshape(B, KVH, g, D)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) * scale
    kpos = torch.arange(S, device=q.device)[None, :] + pos_offset
    lens = cache_len.to(torch.int64)[:, None]
    valid = kpos < lens
    if window is not None:
        valid &= kpos > (lens - 1) - window
    valid = valid[:, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    # guard fully-masked rows: exp(NEG_INF - NEG_INF) would be 1
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.where(valid, torch.exp(logits - m_safe), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype), v).float()
    o = (o / torch.clamp(l, min=1e-20)).reshape(B, H, D)
    lse = (m_safe + torch.log(torch.clamp(l, min=1e-20))).reshape(B, H)
    return o.to(q.dtype), lse


def decode_attention_quant(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, KVH, D) int8
    v: torch.Tensor,  # (B, S, KVH, D) int8
    k_scale: torch.Tensor,  # (B, S, KVH) f32 per-slot, per-head scales
    v_scale: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    pos_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token attention against an int8 cache: the whole cache is
    dequantized to bf16 up front (``value * scale`` in fp32, rounded to
    bf16), then :func:`decode_attention` runs on it, as the JAX oracle does.
    The kernel dequantizes each tile as it loads it instead, to the same bf16
    values. Returns (o (B, H, D) in q's dtype, lse (B, H) fp32)."""
    kd = (k.float() * k_scale[..., None]).to(torch.bfloat16)
    vd = (v.float() * v_scale[..., None]).to(torch.bfloat16)
    return decode_attention(q, kd, vd, cache_len, scale=scale, window=window,
                            pos_offset=pos_offset)


def paged_decode_attention(
    q: torch.Tensor,  # (B, H, D)
    pool_k: torch.Tensor,  # (P, page_size, KVH, D)
    pool_v: torch.Tensor,  # (P, page_size, KVH, D)
    tables: torch.Tensor,  # (B, T) int32 page ids
    kv_len: torch.Tensor,  # (B,) int32
    *,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token attention through a block table: position ``p`` of row
    ``b`` lives in pool page ``tables[b, p // page_size]`` at offset
    ``p % page_size``. Gathers each row's pages into a contiguous
    (B, T * page_size, KVH, D) cache and runs :func:`decode_attention`, as
    the JAX oracle does; positions at and past ``kv_len`` are masked, so
    table entries past the live span never reach the output. Returns
    (o (B, H, D), lse (B, H) fp32)."""
    B, T = tables.shape
    ps = pool_k.shape[1]
    idx = tables.long().reshape(-1)
    kg = pool_k[idx].reshape((B, T * ps) + tuple(pool_k.shape[2:]))
    vg = pool_v[idx].reshape((B, T * ps) + tuple(pool_v.shape[2:]))
    return decode_attention(q, kg, vg, kv_len, scale=scale)


def combine_decode_shards(o_parts: torch.Tensor, lse_parts: torch.Tensor, *,
                          return_lse: bool = False):
    """Exactly combine per-shard (o, lse) of disjoint key ranges, the JAX
    package's ``combine_decode_shards``: o_parts (P, B, H, D), lse_parts
    (P, B, H); ``sum_p o_p exp(lse_p - M) / max(sum_p exp(lse_p - M), 1e-20)``
    with ``M = max_p lse_p``, in o_parts' dtype. With ``return_lse`` also the
    merged lse, ``M + log(max(sum_p exp(lse_p - M), 1e-20))`` (fp32). The plain
    version of the merge step of ``csrc/paged_decode_attention.cu``."""
    m = torch.amax(lse_parts, dim=0, keepdim=True)
    w = torch.exp(lse_parts - m)
    num = torch.sum(o_parts.float() * w[..., None], dim=0)
    den = torch.clamp(torch.sum(w, dim=0), min=1e-20)
    o = (num / den[..., None]).to(o_parts.dtype)
    return (o, (m[0] + torch.log(den)).float()) if return_lse else o


# --------------------------------------------------------------------------- #
# fused sampling: head product + hash Gumbel-max + untempered logprob
# --------------------------------------------------------------------------- #
def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow:
    the constant is split in 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32-style avalanche hash (``repro.kernels.sampling._hash_u32``)
    on uint32 values held in int64 (torch has no full uint32 arithmetic)."""
    x = x & _U32
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def uniform_01(seed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Counter-based uniform in the open interval (0, 1): hash(seed, pos),
    keep 24 bits, centre on the half-ulp grid. ``seed`` is int32 (its bits
    read as uint32), ``pos`` a non-negative index; they broadcast."""
    mixed = _mulmod32(pos.to(torch.int64) & _U32, 0x9E3779B1)
    mixed = (mixed + (seed.to(torch.int64) & _U32)) & _U32
    bits = hash_u32(mixed) >> 8
    return (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def nucleus(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Per row, the smallest set of the largest logits whose probability
    mass reaches ``top_p``, as a bool mask (the top-1 token always in it).
    The sort is stable, so equal logits keep their index order, as JAX's
    ``argsort`` does."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(logits.gather(-1, order), dim=-1)
    # kept while the mass before the token is < top_p: the first token that
    # crosses the threshold is kept too
    keep_sorted = torch.cumsum(probs, dim=-1) - probs < top_p
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter (``ref.top_p_filter`` of the JAX package): the logits
    of each row's :func:`nucleus`, everything else NEG_INF. ``top_p >= 1``
    returns ``logits`` itself."""
    if top_p >= 1.0:
        return logits
    return torch.where(nucleus(logits, top_p), logits, NEG_INF)


def gumbel_max_scores(scaled: torch.Tensor, g: torch.Tensor, top_p: float) -> torch.Tensor:
    """``scaled + g``, and NEG_INF outside each row's nucleus of ``scaled``
    when ``top_p < 1``. The mask is applied after the noise: the hash draw
    gives ``g = +inf`` where ``u`` rounds to 1 (24 one bits), which would
    lift a filtered logit of NEG_INF back over the nucleus."""
    y = scaled + g
    return y if top_p >= 1.0 else torch.where(nucleus(scaled, top_p), y, NEG_INF)


def sample_scores(
    h: torch.Tensor,  # (B, d)
    w_head: torch.Tensor,  # (d, Vp)
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    inv_temp: torch.Tensor,  # (B,) f32; 0.0 = greedy
    *,
    vocab_size: Optional[int] = None,
    top_p: float = 1.0,
    col_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused sampler's fp32 logits ``z`` (padded vocab at NEG_INF) and
    Gumbel-max scores ``y = where(inv_temp == 0, z, z * inv_temp + g)`` with
    ``g = -log(-log(u))``, both (B, Vp); with ``top_p < 1`` the sampled
    rows' scores outside the nucleus of their tempered logits are NEG_INF
    (:func:`gumbel_max_scores`; the filter runs after the temperature, as
    JAX's sampler runs it). ``w_head`` may be the columns of a larger head
    that start at its column ``col_offset``: the hash and the padded-vocab
    mask then read the global column index."""
    return logit_scores(h.float() @ w_head.float(), seeds, inv_temp, vocab_size=vocab_size,
                        top_p=top_p, col_offset=col_offset)


def logit_scores(
    z: torch.Tensor,  # (B, Vp) fp32 logits of the head's columns from col_offset on
    seeds: torch.Tensor,
    inv_temp: torch.Tensor,
    *,
    vocab_size: Optional[int] = None,
    top_p: float = 1.0,
    col_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_scores` from the head's fp32 logits ``z``."""
    Vp = z.shape[1]
    vocab = col_offset + Vp if vocab_size is None else vocab_size
    pos = torch.arange(col_offset, col_offset + Vp, device=z.device)
    valid = pos < vocab
    z = torch.where(valid, z, NEG_INF)
    u = uniform_01(seeds[:, None], pos[None, :])
    g = -torch.log(-torch.log(u))
    it = inv_temp.float()[:, None]
    y = torch.where(it == 0.0, z, gumbel_max_scores(z * it, g, top_p))
    return z, torch.where(valid, y, NEG_INF)


def fused_sample(
    h: torch.Tensor,  # (B, d)
    w_head: torch.Tensor,  # (d, Vp)
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    inv_temp: torch.Tensor,  # (B,) f32; 0.0 = greedy
    *,
    vocab_size: Optional[int] = None,
    top_p: float = 1.0,
    col_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash Gumbel-max sampler the kernel computes, on materialised fp32
    logits (:func:`sample_scores`): the first-max argmax of the scores, padded
    vocab never sampled, and the logprob ``z[tok] - logsumexp(z)`` of the
    untempered, unfiltered masked logits (as JAX's). With ``top_p < 1`` the
    sampled rows draw from the nucleus of their tempered logits; the kernel
    has no such filter. Returns (token (B,) int32, logprob (B,) f32)."""
    z, y = sample_scores(h, w_head, seeds, inv_temp, vocab_size=vocab_size, top_p=top_p,
                         col_offset=col_offset)
    return _draw(z, y)


def sample_logits(
    z: torch.Tensor,  # (B, Vp) fp32 logits of the whole head
    seeds: torch.Tensor,
    inv_temp: torch.Tensor,
    *,
    vocab_size: Optional[int] = None,
    top_p: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_sample` from the head's fp32 logits (a tensor-parallel
    head's, gathered over ``model``)."""
    return _draw(*logit_scores(z, seeds, inv_temp, vocab_size=vocab_size, top_p=top_p))


def _draw(z: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the first-max argmax of the scores y, its logprob under z)."""
    tok = torch.argmax(y, dim=-1)
    lp = z.gather(1, tok[:, None])[:, 0] - torch.logsumexp(z, dim=-1)
    return tok.to(torch.int32), lp


_NO_INDEX = 2**31 - 1  # a state that holds no position yet (the kernel's INT_MAX)


def sample_state(
    h: torch.Tensor,  # (B, d)
    w_head: torch.Tensor,  # (d, V) the head's columns from col_offset on
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    inv_temp: torch.Tensor,  # (B,) f32; 0.0 = greedy
    *,
    vocab_size: Optional[int] = None,
    col_offset: int = 0,
):
    """The sampler's online state over one vocab shard of the head (columns
    ``[col_offset, col_offset + V)``): (max, sum of exp(z - max), best
    score, its z, its global index), each (B,), over the shard's unpadded
    columns; a shard with none gives the empty state (NEG_INF, 0, NEG_INF,
    NEG_INF, the kernel's INT_MAX). The shards' states merged in order
    (:func:`merge_sample_states`) sample as :func:`fused_sample` on the
    whole head: the same tokens bit for bit."""
    z, y = sample_scores(h, w_head, seeds, inv_temp, vocab_size=vocab_size,
                         col_offset=col_offset)
    V = z.shape[1]
    vocab = col_offset + V if vocab_size is None else vocab_size
    valid = torch.arange(col_offset, col_offset + V, device=z.device) < vocab
    m = z.amax(dim=-1)
    l = torch.where(valid, torch.exp(z - m[:, None]), 0.0).sum(dim=-1)
    best = torch.argmax(y, dim=-1)  # the first max
    found = valid.any()
    i = torch.where(found, best + col_offset, _NO_INDEX)
    return (m, l, torch.where(found, y.gather(1, best[:, None])[:, 0], NEG_INF),
            torch.where(found, z.gather(1, best[:, None])[:, 0], NEG_INF), i)


def merge_sample_states(states) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vocab shards' sampler states (:func:`sample_state`) merged in
    shard order with the kernel's merge: (token (B,) int32, logprob (B,)
    f32), the logprob as the kernel's last block forms it."""
    st = states[0]
    for other in states[1:]:
        st = _sample_state_merge(st, other)
    m, l, _, zt, tok = st
    lp = zt - (m + torch.log(torch.clamp(l, min=1e-20)))
    return tok.to(torch.int32), lp


def _sample_state_merge(a, b):
    """Merge two online sampler states (max, sum of exp(z - max), best score,
    its z, its index): the larger score wins, on equal scores the lower
    index. Commutative bit for bit, as the kernel's ``State::merge``."""
    m1, l1, y1, z1, i1 = a
    m2, l2, y2, z2, i2 = b
    mn = torch.maximum(m1, m2)
    l = l1 * torch.exp(m1 - mn) + l2 * torch.exp(m2 - mn)
    take = (y2 > y1) | ((y2 == y1) & (i2 < i1))
    return (mn, l, torch.where(take, y2, y1), torch.where(take, z2, z1),
            torch.where(take, i2, i1))


def _lane_butterfly(st):
    """The kernel's butterfly over 32 lanes (states of shape (B, 32)): after
    steps 16, 8, 4, 2, 1 every lane holds the merge of all; lane 0's."""
    for o in (16, 8, 4, 2, 1):
        perm = torch.arange(32) ^ o
        st = _sample_state_merge(st, tuple(x[:, perm] for x in st))
    return tuple(x[:, 0] for x in st)


def fused_sample_partials(
    h: torch.Tensor,  # (B, d)
    w_head: torch.Tensor,  # (d, Vp)
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    inv_temp: torch.Tensor,  # (B,) f32; 0.0 = greedy
    *,
    vocab_size: Optional[int] = None,
    tile: int = 128,
    tiles_per_block: int = 1,
    col_offset: int = 0,
    return_state: bool = False,
):
    """:func:`fused_sample` computed as ``csrc/sampling.cu`` decomposes it:
    block ``k`` takes the whole tiles ``[k T, (k + 1) T)`` of ``tile`` vocab
    rows (T = ``tiles_per_block``); in a tile, lane ``l`` of 32 takes the
    rows ``l, l + 32, ...`` of a batch column, the lanes merge in a
    butterfly, and the tile's state folds into the column's running state
    in tile order. The blocks' states are then merged as the kernel's last
    block does: lane ``l`` takes blocks ``l, l + 32, ...`` in order, then a
    butterfly. The tokens equal :func:`fused_sample`'s bit for bit (the
    winner is a total order); the logprob differs only by the order of the
    sums. Returns (token (B,) int32, logprob (B,) f32).

    ``col_offset``: ``w_head`` is the vocab shard of a larger head that
    starts at that column (hash positions, the padded-vocab mask and the
    indices are global); ``return_state``: the last block's merged state
    (:func:`sample_state`'s 5-tuple) instead of (token, logprob), as the
    kernel writes it for ``ops.fused_sample_shard``."""
    if tile % 32:
        raise ValueError(f"a tile of {tile} rows does not split over 32 lanes")
    z, y = sample_scores(h, w_head, seeds, inv_temp, vocab_size=vocab_size,
                         col_offset=col_offset)
    z, y = z.cpu(), y.cpu()
    B, Vp = z.shape
    vocab = Vp if vocab_size is None else min(max(vocab_size - col_offset, 0), Vp)

    def empty(*shape):
        return (torch.full(shape, NEG_INF), torch.zeros(shape), torch.full(shape, NEG_INF),
                torch.full(shape, NEG_INF), torch.full(shape, _NO_INDEX, dtype=torch.int64))

    blocks = []
    span = tile * tiles_per_block
    for r0 in range(0, Vp, span):
        st = empty(B)
        for t0 in range(r0, min(r0 + span, Vp), tile):
            pos = torch.arange(t0, t0 + tile).reshape(tile // 32, 32)  # [rr, lane]
            valid = pos < min(vocab, r0 + span, Vp)
            at = pos.clamp(max=Vp - 1)
            zs = torch.where(valid, z[:, at], NEG_INF)  # (B, rows per lane, 32)
            ys = torch.where(valid, y[:, at], NEG_INF)
            m = zs.max(dim=1).values
            l = torch.where(valid, torch.exp(zs - m[:, None]), 0.0).sum(dim=1)
            ymax = ys.max(dim=1).values
            i = torch.where(valid & (ys == ymax[:, None]), pos, _NO_INDEX).min(dim=1).values
            found = i < _NO_INDEX
            zi = torch.where(found, z.gather(1, i.clamp(max=Vp - 1)), NEG_INF)
            lane_st = (m, l, torch.where(found, ymax, NEG_INF), zi, i)
            st = _sample_state_merge(st, _lane_butterfly(lane_st))
        blocks.append(st)
    blocks += [empty(B)] * (-len(blocks) % 32)  # merging an empty state changes no bit
    lanes = empty(B, 32)
    for k in range(0, len(blocks), 32):
        lanes = _sample_state_merge(lanes, tuple(
            torch.stack([blk[f] for blk in blocks[k:k + 32]], 1) for f in range(5)))
    m, l, yt, zt, tok = _lane_butterfly(lanes)
    tok = torch.where(tok < _NO_INDEX, tok + col_offset, tok)
    if return_state:
        return tuple(t.to(h.device) for t in (m, l, yt, zt, tok))
    lp = zt - (m + torch.log(torch.clamp(l, min=1e-20)))
    return tok.to(torch.int32).to(h.device), lp.to(h.device)


def row_inv_temp(temps: torch.Tensor) -> torch.Tensor:
    """Per-row inverse temperatures of the serving sampler: 0 (greedy) where
    ``temps <= 0``, else ``1 / max(temps, 1e-6)`` (``ops.fused_sample_rows``
    of the JAX package)."""
    t = temps.float()
    return torch.where(t <= 0.0, 0.0, 1.0 / torch.clamp(t, min=1e-6))


def fused_sample_rows(
    h: torch.Tensor,  # (B, d)
    w_head: torch.Tensor,  # (d, Vp)
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    temps: torch.Tensor,  # (B,) per-row temperatures; <= 0 = greedy
    *,
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """The serving engine's sampler: :func:`fused_sample` with per-row
    temperatures. Returns the tokens (B,) int32 only."""
    tok, _ = fused_sample(h, w_head, seeds, row_inv_temp(temps), vocab_size=vocab_size)
    return tok


# --------------------------------------------------------------------------- #
# Mamba2 / SSD
# --------------------------------------------------------------------------- #
def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    h0: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Sequential (exact) SSD recurrence, the oracle:

        h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T        (per head)
        y_t = C_t . h_t + D x_t

    x (B,S,NH,P); dt (B,S,NH); A (NH,); B, C (B,S,G,N); D (NH,); h0
    (B,NH,P,N) optional. Returns y (B,S,NH,P) in x's dtype [and the final
    fp32 state if ``return_state``]."""
    b, s, nh, p = x.shape
    n = B.shape[3]
    rep = nh // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2).float()  # (B,S,NH,N)
    Ch = C.repeat_interleave(rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    h = (torch.zeros((b, nh, p, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * A[None, :])[..., None, None]  # (B,NH,1,1)
        dBx = (dtf[:, t, :, None, None] * Bh[:, t, :, None, :]) * xf[:, t, ..., None]
        h = decay * h + dBx
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1) + D[None, None, :, None] * xf
    y = y.to(x.dtype)
    return (y, h) if return_state else y


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j < k <= i} a[..., k] for
    i >= j, -inf above the diagonal (its exp is then exactly 0)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(T, device=a.device)[:, None]
    j = torch.arange(T, device=a.device)[None, :]
    return torch.where(i >= j, diff, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Chunked (state-space dual) form of :func:`ssd_scan`, what the kernel
    computes: within a chunk, ``y = ((C B^T) o L) @ (dt x) + (C o
    exp(a_cum)) @ h^T + D x`` with ``L[i, j] = exp(a_cum[i] - a_cum[j])``
    below the diagonal; across chunks the fp32 state ``h`` is carried.
    ``S`` must be a multiple of ``chunk`` (ValueError otherwise). Sums in
    fp32 (float64 stays float64, for ``gradcheck``)."""
    b, s, nh, p = x.shape
    n = B.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    rep = nh // B.shape[2]
    Bh = _up(B.repeat_interleave(rep, dim=2))
    Ch = _up(C.repeat_interleave(rep, dim=2))
    xf, dtf = _up(x), _up(dt)
    a = dtf * A[None, None, :]  # (B,S,NH) log-decay per step

    def ch(t):  # (B, NC, L, ...)
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xc, dtc, ac, Bc, Cc = ch(xf), ch(dtf), ch(a), ch(Bh), ch(Ch)

    # intra-chunk: L[i, j] = exp(sum_{j<k<=i} a_k), lower-triangular
    Lmat = torch.exp(_segsum(ac.transpose(-1, -2)))  # (B,NC,NH,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    y_intra = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, dtc[..., None] * xc)

    # chunk states: sum_i exp(a_end..i) dt_i B_i x_i^T
    a_cum = torch.cumsum(ac, dim=2)  # (B,NC,L,NH) inclusive
    a_tot = a_cum[:, :, -1:, :]
    decay_to_end = torch.exp(a_tot - a_cum)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc * (dtc * decay_to_end)[..., None], xc)

    # inter-chunk recurrence over the chunk states
    h = (torch.zeros((b, nh, p, n), dtype=xf.dtype, device=x.device)
         if h0 is None else _up(h0))
    chunk_decay = torch.exp(a_tot[:, :, 0, :])  # (B,NC,NH)
    h_in = []
    for c in range(nc):
        h_in.append(h)  # the state entering chunk c
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,NC,NH,P,N)

    # inter-chunk output: y_i += C_i . (exp(a_cum_i) h_in)
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Cc * torch.exp(a_cum)[..., None], h_in)

    y = y_intra + y_inter + D[None, None, None, :, None] * xc
    y = y.reshape(b, s, nh, p).to(x.dtype)
    return (y, h) if return_state else y


def _bf16_split(t: torch.Tensor, hi_lo: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``t`` (fp32) as a bf16 hi + lo pair held in fp32: hi = bf16(t), lo =
    bf16(t - hi); hi + lo keeps about 16 of t's bits (lo = 0 without
    ``hi_lo``: one bf16 pass, 8 bits)."""
    hi = t.to(torch.bfloat16).float()
    return hi, ((t - hi).to(torch.bfloat16).float() if hi_lo else torch.zeros_like(t))


def ssd_chunked_tiles(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 128,
    return_state: bool = False,
    hi_lo: bool = True,
):
    """:func:`ssd_chunked` computed as ``csrc/ssd.cu`` decomposes it, for
    bf16 x, B and C: the chunk padded to a multiple of 16 positions; every
    chunk's own state from a zero start, then the fp32 recurrence
    ``h <- exp(a_tot) h + s_c`` in chunk order; per chunk, ``C h_in^T`` over
    16 state dims at a time, its rows then scaled by ``exp(a_cum)``, and the
    gated scores ``G = (C B^T) exp(a_cum[i] - a_cum[j]) dt_j`` (0 above the
    diagonal) times x over 16 keys at a time; the state as ``x^T W`` over 16
    positions at a time, ``W = B dt exp(a_tot - a_cum)``. G, h_in and W are
    rounded as the kernel's tensor-core operands are: each split into bf16
    hi + lo, the hi product summed before the lo one (``hi_lo=False``: one
    bf16 pass each, which ``tools/ssd_numerics.py`` holds against the
    split). Only the order of the fp32 sums inside each 16-wide product
    differs from the kernel's."""
    b, s, nh, p = x.shape
    n = B.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc, L, rep = s // chunk, -(-chunk // 16) * 16, nh // B.shape[2]

    def tiles(t):  # (B, S, NH, ...) -> (B, NC, NH, L, ...), padded with zeros
        t = t.reshape((b, nc, chunk) + tuple(t.shape[2:])).movedim(2, 3)
        return torch.nn.functional.pad(t, [0, 0] * (t.dim() - 4) + [0, L - chunk])

    xc, dtc = tiles(x.float()), tiles(dt.float())
    Bc = tiles(B.repeat_interleave(rep, dim=2).float())
    Cc = tiles(C.repeat_interleave(rep, dim=2).float())
    a_cum = torch.cumsum(dtc * A[:, None], dim=-1)  # (B,NC,NH,L)
    a_tot = a_cum[..., chunk - 1]
    pos = torch.arange(L, device=x.device)
    below = pos[:, None] >= pos[None, :]
    diff = torch.where(below, a_cum[..., :, None] - a_cum[..., None, :], 0.0)
    G_hi, G_lo = _bf16_split(torch.where(
        below, (Cc @ Bc.transpose(-1, -2)) * torch.exp(diff) * dtc[..., None, :], 0.0), hi_lo)
    W_hi, W_lo = _bf16_split(Bc * (dtc * torch.exp(a_tot[..., None] - a_cum))[..., None], hi_lo)

    states = torch.zeros((b, nc, nh, p, n), dtype=torch.float32, device=x.device)
    for k in range(0, L, 16):
        xt = xc[..., k:k + 16, :].transpose(-1, -2)
        states = states + xt @ W_hi[..., k:k + 16, :]
        states = states + xt @ W_lo[..., k:k + 16, :]
    h = torch.zeros((b, nh, p, n), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(a_tot[:, c])[..., None, None] * h + states[:, c]
    h_hi, h_lo = _bf16_split(torch.stack(h_in, dim=1), hi_lo)

    y = torch.zeros((b, nc, nh, L, p), dtype=torch.float32, device=x.device)
    for k in range(0, n, 16):
        y = y + Cc[..., k:k + 16] @ h_hi[..., k:k + 16].transpose(-1, -2)
        y = y + Cc[..., k:k + 16] @ h_lo[..., k:k + 16].transpose(-1, -2)
    y = y * torch.exp(a_cum)[..., None]
    for k in range(0, L, 16):
        y = y + G_hi[..., k:k + 16] @ xc[..., k:k + 16, :]
        y = y + G_lo[..., k:k + 16] @ xc[..., k:k + 16, :]
    y = y + D[:, None, None] * xc
    y = y[..., :chunk, :].movedim(3, 2).reshape(b, s, nh, p).to(x.dtype)
    return (y, h) if return_state else y


def ssd_decode_step(
    x: torch.Tensor,  # (B, NH, P)
    dt: torch.Tensor,  # (B, NH)
    A: torch.Tensor,  # (NH,)
    B: torch.Tensor,  # (B, G, N)
    C: torch.Tensor,  # (B, G, N)
    D: torch.Tensor,  # (NH,)
    h: torch.Tensor,  # (B, NH, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD step. Returns (y (B, NH, P) in x's dtype, next state in
    h's dtype)."""
    rep = x.shape[1] // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).float()
    Ch = C.repeat_interleave(rep, dim=1).float()
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A[None, :])[..., None, None]
    dBx = (dtf[..., None, None] * Bh[:, :, None, :]) * xf[..., None]
    h_next = decay * h.float() + dBx
    y = torch.einsum("bhpn,bhn->bhp", h_next, Ch) + D[None, :, None] * xf
    return y.to(x.dtype), h_next.to(h.dtype)
