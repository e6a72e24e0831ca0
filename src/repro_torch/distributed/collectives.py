"""Collectives over a rank mesh: the port of ``repro.distributed.collectives``,
with the data movement that JAX leaves to GSPMD.

A value on a rank mesh (``core.databuffer.DeviceMesh`` with a
``torch_mesh``) is held as this rank's shard, a plain local tensor, under a
spec (``distributed.sharding``). The kernels write through ``data_ptr()``,
so they only ever see such plain tensors, never a DTensor. The helpers here
move shards by the spec's ``named`` placements:

- :func:`all_gather` rebuilds the global value from the shards, one mesh
  axis at a time (the innermost first) over that axis's process group;
- :func:`repartition` takes a shard under one spec to the shard under
  another: a local slice when the target region is already held, else an
  all-gather and a slice;
- :func:`reduce_scatter` sums a value that every rank holds whole (a
  gradient of its own rows) over the ranks and keeps this rank's shard;
- :func:`all_reduce` sums over every rank.

**Transport.** ``torch.distributed``'s gloo backend is the one that runs
where ranks share a card (NCCL refuses two ranks on one device), and gloo
moves host tensors. :func:`transport` chooses, from the backend alone, the
device that a collective's buffers lie on: the host for gloo, the mesh's
device for NCCL. A card's tensors for a gloo group are copied to the host,
moved there and copied back.

``seq_sharded_decode_attention`` is the decode path for GQA archs whose
kv_heads do not divide TP: the KV cache is sequence-sharded over `model`,
each shard computes a partial flash decode (o, lse) with ``ops.
decode_attention`` on its own slots, and the shards combine with the exact
log-sum-exp merge.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.databuffer import rank_coords
from repro_torch.distributed import sharding as shr
from repro_torch.kernels import ops


def transport(mesh) -> torch.device:
    """The device a collective's buffers lie on: the host for a gloo group,
    the mesh's device otherwise (NCCL)."""
    import torch.distributed as dist

    return torch.device("cpu") if dist.get_backend() == "gloo" else mesh.device


def region(mesh, shape: Sequence[int], spec, coords=None) -> Tuple[slice, ...]:
    """The region of a global ``shape`` that the rank at ``coords`` (this
    rank's by default) holds under ``spec``: each split dim cut into equal
    blocks, indexed row-major over its axes (the first the outermost)."""
    coords = mesh.coords if coords is None else coords
    out = []
    for dim, axes in zip(shape, shr.dim_axes(spec, len(shape))):
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {axes} ({n})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def global_shape(mesh, local_shape: Sequence[int], spec) -> Tuple[int, ...]:
    """The global shape whose shard under ``spec`` is ``local_shape``."""
    return tuple(n * math.prod(mesh.shape[a] for a in axes)
                 for n, axes in zip(local_shape, shr.dim_axes(spec, len(local_shape))))


def shard(mesh, full: torch.Tensor, spec) -> torch.Tensor:
    """This rank's shard of a value every rank holds whole."""
    return full[region(mesh, full.shape, spec)]


def _group(mesh, axis: str):
    return mesh.torch_mesh.get_group(mesh_dim=axis)


def all_gather(mesh, local: torch.Tensor, spec) -> torch.Tensor:
    """The global value from every rank's shard under ``spec``, on this
    rank's device. A mesh without a world holds values whole."""
    if mesh.torch_mesh is None:
        return local
    import torch.distributed as dist

    wire = transport(mesh)
    x = local.to(wire).contiguous()
    placements = shr.named(mesh, spec, local.dim())
    # the mesh's last axis first: of two axes splitting one dim, the inner
    for axis, placement in reversed(list(zip(mesh.axis_names, placements))):
        n = mesh.shape[axis]
        if n == 1 or not placement.is_shard():
            continue
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=_group(mesh, axis))
        x = torch.cat(parts, dim=placement.dim)
    return x.to(local.device)


def _contains(outer: Tuple[slice, ...], inner: Tuple[slice, ...]) -> bool:
    return all(o.start <= i.start and i.stop <= o.stop for o, i in zip(outer, inner))


def repartition(mesh, x: torch.Tensor, spec, src_spec=None) -> torch.Tensor:
    """The databuffer's redistribution primitive as a standalone helper: this
    rank's shard ``x`` under ``src_spec`` (None: whole) to its shard under
    ``spec``. Where every rank already holds its target region, each slices
    it out locally; otherwise every rank takes part in an all-gather over
    the source's axes (a collective: the ranks decide alike)."""
    if mesh.torch_mesh is None:
        return x
    shape = global_shape(mesh, x.shape, src_spec)
    have, want = region(mesh, shape, src_spec), region(mesh, shape, spec)
    ranks = [rank_coords(mesh.shape, r) for r in range(mesh.num_ranks)]
    if all(_contains(region(mesh, shape, src_spec, c), region(mesh, shape, spec, c))
           for c in ranks):
        return x[tuple(slice(w.start - h.start, w.stop - h.start)
                       for h, w in zip(have, want))]
    return all_gather(mesh, x, src_spec)[want]


def all_reduce(mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over every rank (a new tensor on ``x``'s device)."""
    if mesh.torch_mesh is None:
        return x
    import torch.distributed as dist

    wire = x.to(transport(mesh), copy=True).contiguous()
    dist.all_reduce(wire)
    return wire.to(x.device)


def reduce_scatter(mesh, tensors: List[torch.Tensor], specs: List) -> List[torch.Tensor]:
    """Sum ``tensors`` (each held whole by every rank) over the ranks and
    keep this rank's shard of each under its spec, in fp32. All leaves
    cross in one flat buffer. gloo has no reduce-scatter of its own on every
    torch version the port runs, so the sum is an all-reduce and the
    scatter a local slice."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    flat = all_reduce(mesh, flat)
    out, pos = [], 0
    for t, spec in zip(tensors, specs):
        full = flat[pos:pos + t.numel()].view(t.shape)
        pos += t.numel()
        out.append(shard(mesh, full, spec).clone())
    return out


def seq_sharded_decode_attention(
    mesh,
    q: torch.Tensor,  # (B, H, D) the same on every rank of `axis`
    k: torch.Tensor,  # (B, S/n, KVH, D) this rank's slots of the cache
    v: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) int32, global lengths
    *,
    axis: str = "model",
    window: Optional[int] = None,
    return_lse: bool = False,
):
    """Flash decode over a cache whose slots are split over ``axis``: each
    rank runs ``ops.decode_attention`` on its ``S/n`` slots against the
    length that falls in them, ``clamp(cache_len - rank * S/n, 0, S/n)``;
    the ranks all-gather (o, lse) and merge them exactly. A shard that holds
    no live key of a row returns lse = -1e30 (the kernel) or -5e29 (the
    plain version) for it; either weighs exp(lse - max) = 0 in the merge.
    With ``return_lse`` the merged lse comes back too."""
    del window  # SWA archs bound the cache with a ring instead, as in JAX
    shard_s = k.shape[1]
    idx = mesh.coords[axis]
    eff_len = torch.clamp(cache_len - idx * shard_s, 0, shard_s).to(torch.int32)
    o, lse = ops.decode_attention(q, k, v, eff_len)
    spec = (axis,)
    o_all = all_gather(mesh, o[None], spec)
    lse_all = all_gather(mesh, lse[None], spec)
    return ops.combine_decode_shards(o_all, lse_all, return_lse=return_lse)
