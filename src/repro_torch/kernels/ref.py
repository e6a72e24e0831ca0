"""Plain PyTorch versions of the four kernels of the serving slice.

Each function computes what its CUDA kernel computes, on any device, with
ordinary tensor ops. The CPU tests hold them against the JAX package
(``repro.kernels.ref`` and the Pallas kernels in interpret mode), and
``chip_smoke.py`` holds each kernel against them on the card.

Shapes (the JAX package's conventions, kept at every public function):
  q              (B, S, H, D)
  k, v           (B, S, KVH, D)      KVH | H  (GQA groups = H // KVH)
  decode q       (B, H, D)           single new token per sequence
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_U32 = 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# rmsnorm
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in fp32, output in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


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
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
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


def sample_scores(
    h: torch.Tensor,  # (B, d)
    w_head: torch.Tensor,  # (d, Vp)
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    inv_temp: torch.Tensor,  # (B,) f32; 0.0 = greedy
    *,
    vocab_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused sampler's fp32 logits ``z`` (padded vocab at NEG_INF) and
    Gumbel-max scores ``y = where(inv_temp == 0, z, z * inv_temp + g)`` with
    ``g = -log(-log(u))``, both (B, Vp)."""
    z = h.float() @ w_head.float()
    Vp = z.shape[1]
    vocab = Vp if vocab_size is None else vocab_size
    pos = torch.arange(Vp, device=z.device)
    valid = pos < vocab
    z = torch.where(valid, z, NEG_INF)
    u = uniform_01(seeds[:, None], pos[None, :])
    g = -torch.log(-torch.log(u))
    it = inv_temp.float()[:, None]
    y = torch.where(it == 0.0, z, z * it + g)
    return z, torch.where(valid, y, NEG_INF)


def fused_sample(
    h: torch.Tensor,  # (B, d)
    w_head: torch.Tensor,  # (d, Vp)
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    inv_temp: torch.Tensor,  # (B,) f32; 0.0 = greedy
    *,
    vocab_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash Gumbel-max sampler the kernel computes, on materialised fp32
    logits (:func:`sample_scores`): the first-max argmax of the scores, padded
    vocab never sampled, and the logprob ``z[tok] - logsumexp(z)`` of the
    untempered masked logits. Returns (token (B,) int32, logprob (B,) f32)."""
    z, y = sample_scores(h, w_head, seeds, inv_temp, vocab_size=vocab_size)
    tok = torch.argmax(y, dim=-1)
    lp = z.gather(1, tok[:, None])[:, 0] - torch.logsumexp(z, dim=-1)
    return tok.to(torch.int32), lp
