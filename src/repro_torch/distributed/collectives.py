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
- :func:`all_reduce` sums (or takes the max) over every rank.

Each takes ``axes=``, the mesh axes it works over (None: every axis): a
tensor-parallel step sums its grads over the data axes only and keeps the
``model`` shard, and the model code reduces over ``model`` only.
:class:`CopyToModel`, :class:`ReduceFromModel` and :class:`GatherFromModel`
are the Megatron region operators over ``model`` as autograd Functions
(``distributed.constraint`` applies them on the ambient mesh).

**Transport.** ``torch.distributed``'s gloo backend is the one that runs
where ranks share a card (NCCL refuses two ranks on one device), and gloo
moves host tensors. :func:`transport` chooses, from the backend alone, the
device that a collective's buffers lie on: the host for gloo, the mesh's
device for NCCL. A card's tensors for a gloo group are copied to the host,
moved there and copied back.

``seq_sharded_decode_attention`` is the decode path of a cache split by
slot over `model`: each shard computes a partial flash decode (o, lse) with
``ops.decode_attention`` on its own slots, and the shards combine with the
exact log-sum-exp merge; ``seq_sharded_decode_attention_quant`` is the same
over an int8 cache (``ops.decode_attention_quant``).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.databuffer import rank_coords
from repro_torch.distributed import sharding as shr
from repro_torch.kernels import ops


def transport(mesh) -> torch.device:
    """The device a collective's buffers lie on: the host for a gloo group,
    the mesh's device otherwise (NCCL)."""
    import torch.distributed as dist

    return torch.device("cpu") if dist.get_backend() == "gloo" else mesh.device


def _splits(spec, ndim: int, axes) -> Tuple[Tuple[str, ...], ...]:
    """``shr.dim_axes`` restricted to the mesh axes in ``axes`` (None: all)."""
    per_dim = shr.dim_axes(spec, ndim)
    if axes is None:
        return per_dim
    return tuple(tuple(a for a in d if a in axes) for d in per_dim)


def region(mesh, shape: Sequence[int], spec, coords=None, axes=None) -> Tuple[slice, ...]:
    """The region of a global ``shape`` that the rank at ``coords`` (this
    rank's by default) holds under ``spec``: each split dim cut into equal
    blocks, indexed row-major over its axes (the first the outermost). With
    ``axes``, only those mesh axes split ``shape``."""
    coords = mesh.coords if coords is None else coords
    out = []
    for dim, split in zip(shape, _splits(spec, len(shape), axes)):
        n, idx = 1, 0
        for a in split:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {split} ({n})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def global_shape(mesh, local_shape: Sequence[int], spec, axes=None) -> Tuple[int, ...]:
    """The global shape whose shard under ``spec`` (over ``axes``) is
    ``local_shape``."""
    return tuple(n * math.prod(mesh.shape[a] for a in split)
                 for n, split in zip(local_shape, _splits(spec, len(local_shape), axes)))


def shard(mesh, full: torch.Tensor, spec, axes=None) -> torch.Tensor:
    """This rank's shard of a value every rank holds whole (over ``axes``:
    whole as far as those axes go)."""
    return full[region(mesh, full.shape, spec, axes=axes)]


def _group(mesh, axis: str):
    return mesh.torch_mesh.get_group(mesh_dim=axis)


def all_gather(mesh, local: torch.Tensor, spec, axes=None) -> torch.Tensor:
    """The global value from every rank's shard under ``spec``, on this
    rank's device; with ``axes``, gathered over those mesh axes only. A mesh
    without a world holds values whole, and a shard that no axis of
    ``axes`` splits comes back as it is."""
    if mesh.torch_mesh is None:
        return local
    placements = shr.named(mesh, spec, local.dim())
    # the mesh's last axis first: of two axes splitting one dim, the inner
    todo = [(axis, pl) for axis, pl in reversed(list(zip(mesh.axis_names, placements)))
            if mesh.shape[axis] > 1 and pl.is_shard() and (axes is None or axis in axes)]
    if not todo:
        return local
    import torch.distributed as dist

    x = local.to(transport(mesh)).contiguous()
    for axis, placement in todo:
        parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
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


def all_reduce(mesh, x: torch.Tensor, axes=None, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the max) of ``x`` over every rank, or over the
    mesh axes in ``axes`` one after another (a new tensor on ``x``'s
    device)."""
    if mesh.torch_mesh is None:
        return x
    import torch.distributed as dist

    names = [a for a in mesh.axis_names if mesh.shape[a] > 1 and (axes is None or a in axes)]
    if not names:
        return x.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    wire = x.to(transport(mesh), copy=True).contiguous()
    if axes is None or len(names) == sum(mesh.shape[a] > 1 for a in mesh.axis_names):
        dist.all_reduce(wire, op=red)
    else:
        for a in names:
            dist.all_reduce(wire, op=red, group=_group(mesh, a))
    return wire.to(x.device)


def reduce_scatter(mesh, tensors: List[torch.Tensor], specs: List,
                   axes=None) -> List[torch.Tensor]:
    """Sum ``tensors`` (each held whole by every rank, as far as ``axes``
    go) over the ranks of ``axes`` (None: every rank) and keep this rank's
    shard of each under its spec over those axes, in fp32. All leaves cross
    in one flat buffer. gloo has no reduce-scatter of its own on every torch
    version the port runs, so the sum is an all-reduce and the scatter a
    local slice."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    flat = all_reduce(mesh, flat, axes=axes)
    out, pos = [], 0
    for t, spec in zip(tensors, specs):
        full = flat[pos:pos + t.numel()].view(t.shape)
        pos += t.numel()
        out.append(shard(mesh, full, spec, axes=axes).clone())
    return out


# --------------------------------------------------------------------------- #
# the Megatron region operators over `model`, as autograd Functions
# --------------------------------------------------------------------------- #
MODEL = ("model",)


class CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over ``model`` (or
    over the mesh axes ``axes``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes=MODEL):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g, axes=ctx.axes), None, None


class ReduceFromModel(torch.autograd.Function):
    """The sum over ``model`` (or over the mesh axes ``axes``) forward;
    identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes=MODEL):
        return all_reduce(mesh, x, axes=axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class GatherFromModel(torch.autograd.Function):
    """The ranks' pieces of ``dim`` concatenated in rank order forward;
    backward, this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return all_gather(mesh, x, (None,) * dim + ("model",), axes=MODEL)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.coords["model"]
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


def seq_sharded_decode_attention(
    mesh,
    q: torch.Tensor,  # (B, H, D) the same on every rank of `axis`
    k: torch.Tensor,  # (B, S/n, KVH, D) this rank's slots of the cache
    v: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) int32, global lengths
    *,
    axis: str = "model",
    return_lse: bool = False,
):
    """Flash decode over a cache whose slots are split over ``axis``: each
    rank runs ``ops.decode_attention`` on its ``S/n`` slots against the
    length that falls in them, ``clamp(cache_len - rank * S/n, 0, S/n)``;
    the ranks all-gather (o, lse) and merge them exactly. A shard that holds
    no live key of a row returns lse = -1e30 (the kernel) or -5e29 (the
    plain version) for it; either weighs exp(lse - max) = 0 in the merge.
    With ``return_lse`` the merged lse comes back too. No window mask is
    applied: a sliding window's cache is a ring, whose live slots are all in
    the window, and the caller passes their count as ``cache_len``
    (``models/lm.py``)."""
    eff_len = _shard_len(mesh, axis, cache_len, k.shape[1])
    o, lse = ops.decode_attention(q, k, v, eff_len)
    return _merge_shards(mesh, axis, o, lse, return_lse)


def seq_sharded_decode_attention_quant(
    mesh,
    q: torch.Tensor,  # (B, H, D) the same on every rank of `axis`
    k: torch.Tensor,  # (B, S/n, KVH, D) int8: this rank's slots of the cache
    v: torch.Tensor,
    k_scale: torch.Tensor,  # (B, S/n, KVH) f32, the slots' scales
    v_scale: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) int32, global lengths
    *,
    axis: str = "model",
    return_lse: bool = False,
):
    """:func:`seq_sharded_decode_attention` over an int8 cache: each rank
    runs ``ops.decode_attention_quant`` on its slots and their scales, and
    the ranks merge (o, lse) in the same way. A row with no live slot in a
    rank's shard gets lse = -1e30 from the kernel (its splits write
    NEG_INF only, ``csrc/split_kv.cuh``) and -5e29 from the plain version,
    as in the bf16 kernel: weight 0 in the merge."""
    eff_len = _shard_len(mesh, axis, cache_len, k.shape[1])
    o, lse = ops.decode_attention_quant(q, k, v, k_scale, v_scale, eff_len)
    return _merge_shards(mesh, axis, o, lse, return_lse)


def _shard_len(mesh, axis: str, cache_len: torch.Tensor, shard_s: int) -> torch.Tensor:
    """The live slots of each row in this rank's ``shard_s`` slots."""
    idx = mesh.coords[axis]
    return torch.clamp(cache_len - idx * shard_s, 0, shard_s).to(torch.int32)


def _merge_shards(mesh, axis: str, o, lse, return_lse: bool):
    """The ranks' (o, lse) of disjoint slot ranges all-gathered over
    ``axis`` and merged exactly (``ops.combine_decode_shards``)."""
    spec = (axis,)
    o_all = all_gather(mesh, o[None], spec)
    lse_all = all_gather(mesh, lse[None], spec)
    return ops.combine_decode_shards(o_all, lse_all, return_lse=return_lse)
