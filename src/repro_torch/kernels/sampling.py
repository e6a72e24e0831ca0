"""Fused decode-step sampler: ``csrc/sampling.cu`` on CUDA tensors, the plain
version on CPU tensors. Port of ``repro.kernels.sampling.fused_sample``.

Head product, online log-sum-exp of the untempered logits and a hash
Gumbel-max draw (splitmix32 over seed x vocab index) in one call; returns
(token (B,) int32, logprob (B,) fp32 of that token under the untempered
masked distribution). ``inv_temp == 0`` is greedy with the first-max rule.

The kernel reads the head as (Vp, d) rows: ``w_head`` (d, Vp) must be the
transpose of a contiguous (Vp, d) matrix, as the tied head ``embed.T`` is.
It is never made contiguous, which would copy the whole head on every step.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_sample as plain

_c = ctypes


@functools.lru_cache(maxsize=None)
def _fwd():
    return _build.entry("sampling", "fused_sample_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
        _c.c_void_p, _c.c_void_p, _c.c_void_p,
        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p])


@functools.lru_cache(maxsize=None)
def _num_tiles():
    f = _build.library("sampling").fused_sample_num_tiles
    f.argtypes = [_c.c_int]
    f.restype = _c.c_int
    return f


def fused_sample(
    h: torch.Tensor,  # (B, d)
    w_head: torch.Tensor,  # (d, Vp)
    seeds: torch.Tensor,  # (B,) int32 per-row hash seeds
    inv_temp: torch.Tensor,  # (B,) f32; 0.0 = greedy
    *,
    vocab_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if h.device.type == "cpu":
        return plain(h, w_head, seeds, inv_temp, vocab_size=vocab_size)
    _build.require(h.device.type == "cuda", f"no fused_sample kernel for {h.device}")
    rows = w_head.t()  # (Vp, d): a view, contiguous for the tied head
    _build.require_cuda(h, rows, seeds, inv_temp)
    _build.require(h.dtype == rows.dtype == torch.bfloat16 and seeds.dtype == torch.int32
                   and inv_temp.dtype == torch.float32,
                   f"fused_sample kernel takes bf16 h/head, int32 seeds, f32 inv_temp; got "
                   f"{h.dtype}, {rows.dtype}, {seeds.dtype}, {inv_temp.dtype}")
    B, d = h.shape
    Vp = rows.shape[0]
    _build.require(rows.shape[1] == d and d % 8 == 0 and seeds.shape == (B,)
                   and inv_temp.shape == (B,), f"h {tuple(h.shape)}, head {tuple(w_head.shape)}")
    vocab = Vp if vocab_size is None else min(vocab_size, Vp)
    ntiles = _num_tiles()(Vp)
    part = torch.empty((ntiles, B, 4), dtype=torch.float32, device=h.device)
    part_idx = torch.empty((ntiles, B), dtype=torch.int32, device=h.device)
    tok = torch.empty((B,), dtype=torch.int32, device=h.device)
    lp = torch.empty((B,), dtype=torch.float32, device=h.device)
    device, stream = _build.launch_site(h)
    err = _fwd()(h.data_ptr(), rows.data_ptr(), seeds.data_ptr(), inv_temp.data_ptr(),
                 part.data_ptr(), part_idx.data_ptr(), tok.data_ptr(), lp.data_ptr(),
                 B, d, Vp, vocab, device, stream)
    _build.check(_build.library("sampling"), err, "fused_sample")
    _build.LAUNCHES["fused_sample"] += 1
    return tok, lp
