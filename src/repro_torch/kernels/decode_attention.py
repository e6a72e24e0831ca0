"""Decode attention: ``csrc/decode_attention.cu`` on CUDA tensors, the plain
version on CPU tensors. Port of ``repro.kernels.decode_attention``'s
``decode_attention``.

q (B, H, D) bf16 against a cache k, v (B, S, KVH, D) bf16 with cache_len
(B,) int32 valid slots; returns (o (B, H, D) bf16, lse (B, H) fp32).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.ref import decode_attention as plain

_c = ctypes


@functools.lru_cache(maxsize=None)
def _fwd():
    return _build.entry("decode_attention", "decode_attention_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
        _c.c_float, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p])


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
    if q.device.type == "cpu":
        return plain(q, k, v, cache_len, scale=scale, window=window,
                     pos_offset=pos_offset)
    _build.require(q.device.type == "cuda", f"no decode_attention kernel for {q.device}")
    _build.require_cuda(q, k, v, cache_len)
    _build.require(q.dtype == k.dtype == v.dtype == torch.bfloat16
                   and cache_len.dtype == torch.int32,
                   f"decode_attention kernel takes bf16 q/k/v and int32 cache_len, "
                   f"got {q.dtype}, {cache_len.dtype}")
    B, H, D = q.shape
    _, S, KVH, _ = k.shape
    _build.require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == D
                   and H % KVH == 0 and cache_len.shape == (B,),
                   f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, cache_len {tuple(cache_len.shape)}")
    _build.require(D in HEAD_DIMS, f"decode_attention kernel: head_dim {D} not in {HEAD_DIMS}")
    _build.require(window is None or window >= 1, f"window {window}")
    scale = scale if scale is not None else 1.0 / (D**0.5)
    o = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    device, stream = _build.launch_site(q)
    err = _fwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), B, S, H, KVH, D, scale, window or 0,
                 pos_offset, device, stream)
    _build.check(_build.library("decode_attention"), err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return o, lse
