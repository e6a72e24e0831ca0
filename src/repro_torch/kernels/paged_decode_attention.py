"""Paged decode attention: ``csrc/paged_decode_attention.cu`` on CUDA tensors,
the plain version on CPU tensors. Port of ``repro.kernels.decode_attention``'s
``paged_decode_attention``.

q (B, H, D) bf16 attends a page pool pool_k, pool_v (P, page_size, KVH, D)
bf16 through the block table tables (B, T) int32, with kv_len (B,) int32
valid positions per row; returns (o (B, H, D) bf16, lse (B, H) fp32).
The kernel reads the table entries of each row's live span,
``tables[b, :ceil(kv_len[b] / page_size)]``, as page ids: they must lie in
[0, P). Entries past the live span are never read and may hold anything.

The kernel splits each row's keys into ``ceil(T / split_pages)`` splits of
whole pages (:func:`split_pages`, from the table's shape alone, never from
``kv_len``), attends each split in its own block and merges the splits'
partials by their lse in a fixed order (``ref.combine_decode_shards``'s
arithmetic). The wrapper allocates the fp32 partials.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.ref import paged_decode_attention as plain
from repro_torch.kernels.split_rule import split_pages

_c = ctypes


@functools.lru_cache(maxsize=None)
def _fwd():
    return _build.entry("paged_decode_attention", "paged_decode_attention_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
        _c.c_int, _c.c_int, _c.c_int, _c.c_float, _c.c_int, _c.c_void_p])


def paged_decode_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return plain(q, pool_k, pool_v, tables, kv_len, scale=scale)
    _build.require(q.device.type == "cuda", f"no paged_decode_attention kernel for {q.device}")
    _build.require_no_grad("paged_decode_attention", q, pool_k, pool_v)
    _build.require_cuda(q, pool_k, pool_v, tables, kv_len)
    _build.require(q.dtype == pool_k.dtype == pool_v.dtype == torch.bfloat16
                   and tables.dtype == kv_len.dtype == torch.int32,
                   f"paged_decode_attention kernel takes bf16 q/pool and int32 tables/kv_len, "
                   f"got {q.dtype}, {pool_k.dtype}, {tables.dtype}, {kv_len.dtype}")
    B, H, D = q.shape
    _, ps, KVH, _ = pool_k.shape
    T = tables.shape[1]
    _build.require(pool_k.shape == pool_v.shape and pool_k.shape[3] == D and H % KVH == 0
                   and tables.shape == (B, T) and kv_len.shape == (B,),
                   f"q {tuple(q.shape)}, pool {tuple(pool_k.shape)}, tables "
                   f"{tuple(tables.shape)}, kv_len {tuple(kv_len.shape)}")
    _build.require(D in HEAD_DIMS,
                   f"paged_decode_attention kernel: head_dim {D} not in {HEAD_DIMS}")
    scale = scale if scale is not None else 1.0 / (D**0.5)
    sp = split_pages(B, H, KVH, T, ps)
    nsplit = -(-T // sp)
    o = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    o_part = torch.empty((nsplit, B, H, D), dtype=torch.float32, device=q.device)
    lse_part = torch.empty((nsplit, B, H), dtype=torch.float32, device=q.device)
    device, stream = _build.launch_site(q)
    err = _fwd()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(),
                 kv_len.data_ptr(), o.data_ptr(), lse.data_ptr(), o_part.data_ptr(),
                 lse_part.data_ptr(), B, T, ps, H, KVH, D, sp, scale, device, stream)
    _build.check(_build.library("paged_decode_attention"), err, "paged_decode_attention")
    _build.LAUNCHES["paged_decode_attention"] += 1
    return o, lse
