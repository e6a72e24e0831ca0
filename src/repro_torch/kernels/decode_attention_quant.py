"""Decode attention over an int8 KV cache: ``csrc/decode_attention_quant.cu``
on CUDA tensors, the plain version on CPU tensors. Port of
``repro.kernels.decode_attention``'s ``decode_attention_quant``.

q (B, H, D) bf16 against an int8 cache k, v (B, S, KVH, D) with f32 scales
k_scale, v_scale (B, S, KVH), one per slot and KV head, and cache_len (B,)
int32 valid slots; returns (o (B, H, D) bf16, lse (B, H) fp32). The kernel
dequantizes each tile as it loads it (``value * scale`` rounded to bf16), so
the bf16 cache never exists in device memory. It splits the slots and merges
the splits as ``decode_attention`` does, with the same split rule.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.ref import decode_attention_quant as plain
from repro_torch.kernels.split_rule import split_keys

_c = ctypes


@functools.lru_cache(maxsize=None)
def _fwd():
    return _build.entry("decode_attention_quant", "decode_attention_quant_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_int,
        _c.c_int, _c.c_int, _c.c_int, _c.c_float, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p])


def decode_attention_quant(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    pos_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return plain(q, k, v, k_scale, v_scale, cache_len, scale=scale, window=window,
                     pos_offset=pos_offset)
    _build.require(q.device.type == "cuda",
                   f"no decode_attention_quant kernel for {q.device}")
    _build.require_no_grad("decode_attention_quant", q, k_scale, v_scale)
    _build.require_cuda(q, k, v, k_scale, v_scale, cache_len)
    _build.require(q.dtype == torch.bfloat16 and k.dtype == v.dtype == torch.int8
                   and k_scale.dtype == v_scale.dtype == torch.float32
                   and cache_len.dtype == torch.int32,
                   f"decode_attention_quant kernel takes bf16 q, int8 k/v, f32 scales and "
                   f"int32 cache_len, got {q.dtype}, {k.dtype}, {k_scale.dtype}, "
                   f"{cache_len.dtype}")
    B, H, D = q.shape
    _, S, KVH, _ = k.shape
    _build.require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == D
                   and k_scale.shape == v_scale.shape == (B, S, KVH)
                   and H % KVH == 0 and cache_len.shape == (B,),
                   f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, scales "
                   f"{tuple(k_scale.shape)}, cache_len {tuple(cache_len.shape)}")
    _build.require(D in HEAD_DIMS,
                   f"decode_attention_quant kernel: head_dim {D} not in {HEAD_DIMS}")
    _build.require(window is None or window >= 1, f"window {window}")
    scale = scale if scale is not None else 1.0 / (D**0.5)
    sk = split_keys(B, H, KVH, S)
    nsplit = -(-S // sk)
    o = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    o_part = torch.empty((nsplit, B, H, D), dtype=torch.float32, device=q.device)
    lse_part = torch.empty((nsplit, B, H), dtype=torch.float32, device=q.device)
    device, stream = _build.launch_site(q)
    err = _fwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                 v_scale.data_ptr(), cache_len.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 o_part.data_ptr(), lse_part.data_ptr(), B, S, H, KVH, D, sk, scale,
                 window or 0, pos_offset, device, stream)
    _build.check(_build.library("decode_attention_quant"), err, "decode_attention_quant")
    _build.LAUNCHES["decode_attention_quant"] += 1
    return o, lse
