"""Prefill attention: ``csrc/flash_attention.cu`` on CUDA tensors, the plain
version on CPU tensors. Port of ``repro.kernels.flash_attention``.

Layouts: q (B, Sq, H, D); k, v (B, Sk, KVH, D); out (B, Sq, H, D), bf16.
Unlike the TPU kernel, any Sq and Sk are taken: ragged tails are masked.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as plain

_c = ctypes
HEAD_DIMS = (64, 128, 256)  # the head widths the kernel is instantiated for


@functools.lru_cache(maxsize=None)
def _fwd():
    return _build.entry("flash_attention", "flash_attention_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
        _c.c_float, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p])


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
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, scale=scale,
                     q_offset=q_offset)
    _build.require(q.device.type == "cuda", f"no flash_attention kernel for {q.device}")
    _build.require_cuda(q, k, v)
    _build.require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
                   f"flash_attention kernel takes bf16, got {q.dtype}")
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    _build.require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == D
                   and H % KVH == 0, f"q {tuple(q.shape)}, k/v {tuple(k.shape)}")
    _build.require(D in HEAD_DIMS, f"flash_attention kernel: head_dim {D} not in {HEAD_DIMS}")
    _build.require(window is None or window >= 1, f"window {window}")
    _build.require(q_offset >= 0, f"q_offset {q_offset}")
    scale = scale if scale is not None else 1.0 / (D**0.5)
    out = torch.empty_like(q)
    device, stream = _build.launch_site(q)
    err = _fwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, KVH, D, scale, int(causal), window or 0, q_offset,
                 device, stream)
    _build.check(_build.library("flash_attention"), err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
