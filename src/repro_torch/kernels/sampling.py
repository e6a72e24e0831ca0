"""Fused decode-step sampler: ``csrc/sampling.cu`` on CUDA tensors, the plain
version on CPU tensors. Port of ``repro.kernels.sampling.fused_sample``.

Head product, online log-sum-exp of the untempered logits and a hash
Gumbel-max draw (splitmix32 over seed x vocab index) in one call; returns
(token (B,) int32, logprob (B,) fp32 of that token under the untempered
masked distribution). ``inv_temp == 0`` is greedy with the first-max rule.

The kernel reads the head ``w_head`` (d, Vp) as it lies, in either of two
layouts, which the wrapper tells apart by the strides: the transpose of a
contiguous (Vp, d) matrix, as the tied head ``embed.T`` is, or a contiguous
(d, Vp) matrix, as an untied ``lm_head`` is. Any other layout raises. The
head is never made contiguous, which would copy the whole head on every
step. One launch: a persistent grid of tensor-core blocks over fixed vocab ranges
(:func:`grid`), whose last block merges the blocks' partials in a fixed
order; ``ref.fused_sample_partials`` is that decomposition in plain PyTorch.

On a tensor-parallel mesh each rank holds a vocab shard of the head: with
``col_offset`` (the shard's first column in the whole head) the hash
positions, the padded-vocab mask and the first-max tie-break read global
indices, and with ``state=True`` the last block writes its merged online
state instead of (token, logprob): (max, sum of exp, best score, its logit)
as (B, 4) fp32 and the best index as (B,) int32, which
``ops.fused_sample_shard`` gathers over the ranks and merges in rank order
(``ref.sample_state`` is the plain version).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_sample as plain
from repro_torch.kernels.ref import sample_state

_c = ctypes


@functools.lru_cache(maxsize=None)
def _fwd():
    return _build.entry("sampling", "fused_sample_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
        _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_void_p])


@functools.lru_cache(maxsize=None)
def grid(B: int, Vp: int, device: int, cols: bool = False) -> Tuple[int, int, int]:
    """(blocks along the vocab, tiles each block walks, vocab rows of a
    tile) of the kernel for this batch and head on this device: as many
    blocks as the card holds at once, block k over the whole tiles
    ``[k tiles, (k + 1) tiles)``. ``cols``: the head lies as (d, Vp)."""
    f = _build.entry("sampling", "fused_sample_grid", [
        _c.c_int, _c.c_int, _c.c_int, _c.c_int] + [_c.POINTER(_c.c_int)] * 3)
    out = [_c.c_int() for _ in range(3)]
    err = f(B, Vp, int(cols), device, *(_c.byref(x) for x in out))
    _build.check(_build.library("sampling"), err, "fused_sample grid")
    return tuple(x.value for x in out)


@functools.lru_cache(maxsize=None)
def _ticket(device: int, stream: int) -> torch.Tensor:
    """The launches' last-block ticket on one stream of one device: a
    uint32 that is zero between launches (each launch's last block leaves
    it at zero), so it is made once and never reset."""
    return torch.zeros((1,), dtype=torch.int32, device=torch.device("cuda", device))


def head_layout(w_head: torch.Tensor) -> Optional[bool]:
    """How the kernel reads ``w_head`` (d, Vp): False for the transpose of a
    contiguous (Vp, d) matrix (the tied ``embed.T``), True for a contiguous
    (d, Vp) matrix (an untied ``lm_head``), None for any other layout."""
    d, Vp = w_head.shape
    if w_head.stride() == (1, d):
        return False
    if w_head.stride() == (Vp, 1):
        return True
    return None


def fused_sample(
    h: torch.Tensor,  # (B, d)
    w_head: torch.Tensor,  # (d, Vp)
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    inv_temp: torch.Tensor,  # (B,) f32; 0.0 = greedy
    *,
    vocab_size: Optional[int] = None,
    col_offset: int = 0,
    state: bool = False,
):
    """(token (B,) int32, logprob (B,) fp32); with ``state``, the merged
    online state of this vocab shard: ((B, 4) fp32 (max, sum of exp, best
    score, its logit), (B,) int32 best global index)."""
    if h.device.type == "cpu":
        if state:
            m, l, y, z, i = sample_state(h, w_head, seeds, inv_temp, vocab_size=vocab_size,
                                         col_offset=col_offset)
            return torch.stack([m, l, y, z], dim=1), i.to(torch.int32)
        return plain(h, w_head, seeds, inv_temp, vocab_size=vocab_size,
                     col_offset=col_offset)
    _build.require(h.device.type == "cuda", f"no fused_sample kernel for {h.device}")
    _build.require_no_grad("fused_sample", h, w_head, inv_temp)
    cols = head_layout(w_head)
    _build.require(cols is not None,
                   f"fused_sample kernel reads the head (d, Vp) as (Vp, d) rows or as (d, Vp) "
                   f"rows; got strides {w_head.stride()}")
    # the kernel's view of the head: contiguous in either layout
    _build.require_cuda(h, w_head if cols else w_head.t(), seeds, inv_temp)
    _build.require(h.dtype == w_head.dtype == torch.bfloat16 and seeds.dtype == torch.int32
                   and inv_temp.dtype == torch.float32,
                   f"fused_sample kernel takes bf16 h/head, int32 seeds, f32 inv_temp; got "
                   f"{h.dtype}, {w_head.dtype}, {seeds.dtype}, {inv_temp.dtype}")
    B, d = h.shape
    Vp = w_head.shape[1]
    _build.require(B >= 1 and Vp >= 1 and w_head.shape[0] == d and d % 8 == 0
                   and (not cols or Vp % 8 == 0)
                   and seeds.shape == (B,) and inv_temp.shape == (B,),
                   f"h {tuple(h.shape)}, head {tuple(w_head.shape)}")
    # the columns of this shard that are sampled: [0, vocab)
    vocab = Vp if vocab_size is None else min(max(vocab_size - col_offset, 0), Vp)
    device, stream = _build.launch_site(h)
    blocks, tiles, _ = grid(B, Vp, device, cols)
    part = torch.empty((blocks, B, 4), dtype=torch.float32, device=h.device)
    part_idx = torch.empty((blocks, B), dtype=torch.int32, device=h.device)
    tok = torch.empty((B,), dtype=torch.int32, device=h.device)
    lp = torch.empty((B,), dtype=torch.float32, device=h.device)
    st = torch.empty((B, 4), dtype=torch.float32, device=h.device) if state else None
    err = _fwd()(h.data_ptr(), w_head.data_ptr(), seeds.data_ptr(), inv_temp.data_ptr(),
                 part.data_ptr(), part_idx.data_ptr(), _ticket(device, stream).data_ptr(),
                 tok.data_ptr(), lp.data_ptr(), B, d, Vp, vocab, int(cols), blocks, tiles,
                 st.data_ptr() if state else None, tok.data_ptr() if state else None,
                 col_offset, device, stream)
    _build.check(_build.library("sampling"), err, "fused_sample")
    _build.LAUNCHES["fused_sample"] += 1
    return (st, tok) if state else (tok, lp)
