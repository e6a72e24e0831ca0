"""The ambient rank mesh of the model code: the port of
``repro.distributed.constraint``.

JAX's model code annotates activations with logical entries ('dp', 'tp')
and the ambient mesh (``use_mesh``) resolves them for GSPMD, which inserts
the collectives. The port has no GSPMD: each rank computes on its own shards
and the model code calls the collectives itself, at the same call sites.
So the ambient mesh here is a rank mesh, set with :func:`use_mesh` (the DAG
worker enters its context's mesh for every iteration, the async worker for
each of its halves), and the helpers below are what the model code asks of
it:

- :func:`tp` is the ambient mesh when it splits ``model`` over more than one
  rank of a ``torch.distributed`` world, else None. Without such a mesh
  every helper is a no-op, so the model code stays mesh-agnostic, as in
  JAX, and one device takes exactly its old path;
- :func:`copy_to_model`, :func:`reduce_from_model` and
  :func:`gather_from_model` are the Megatron region operators over the
  ``model`` group (``distributed.collectives``). Where a rank-local partial
  feeds rank-local work again (the gated norm's sum of squares over a width
  split over ``model``), the sum over ``model`` must run in both directions:
  ``copy_to_model(reduce_from_model(s))``. ``reduce_from_model`` alone would
  keep, backward, only this rank's share of the gradient of ``s``;
- :func:`batch_sum` sums a value over the data axes that split the global
  batch (the MoE aux loss's token sums, whose means JAX's GSPMD takes over
  the global batch).

Sequence parallelism (JAX's ``sequence_parallel()``, ``REPRO_SP``, off by
default) is not ported: the residual stream stays replicated over
``model`` between blocks.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_AMBIENT = None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of the model code inside the block."""
    global _AMBIENT
    prev, _AMBIENT = _AMBIENT, mesh
    try:
        yield mesh
    finally:
        _AMBIENT = prev


def tp():
    """The ambient rank mesh when its ``model`` axis has more than one rank,
    else None."""
    mesh = _AMBIENT
    if mesh is None or getattr(mesh, "torch_mesh", None) is None:
        return None
    return mesh if mesh.shape.get("model", 1) > 1 else None


def tp_size() -> int:
    mesh = tp()
    return 1 if mesh is None else mesh.shape["model"]


def tp_rank() -> int:
    mesh = tp()
    return 0 if mesh is None else mesh.coords["model"]


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, the gradient summed over ``model`` backward: where a
    replicated value enters rank-local work."""
    mesh = tp()
    if mesh is None:
        return x
    from repro_torch.distributed import collectives

    return collectives.CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` forward, identity backward: where rank-local
    partial sums become the replicated value."""
    mesh = tp()
    if mesh is None:
        return x
    from repro_torch.distributed import collectives

    return collectives.ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' pieces of ``dim`` concatenated in rank order forward, the
    local slice of the gradient backward."""
    mesh = tp()
    if mesh is None:
        return x
    from repro_torch.distributed import collectives

    return collectives.GatherFromModel.apply(x, mesh, dim % x.dim())


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the ambient rank mesh's data axes
    (every axis but ``model``) that have more than one rank, each of which
    holds its own rows of the global batch, in both directions: every data
    rank then holds the global value, and the ranks' weights of the
    data-parallel step, which sum to one, give each rank's rows their whole
    gradient. One all-reduce forward and one backward; ``x`` as it is
    elsewhere. (The MoE aux loss's token sums, once for all layers.)"""
    mesh = _AMBIENT
    if mesh is None or getattr(mesh, "torch_mesh", None) is None:
        return x
    axes = tuple(a for a in mesh.axis_names if a != "model" and mesh.shape[a] > 1)
    if not axes:
        return x
    from repro_torch.distributed import collectives

    return collectives.CopyToModel.apply(collectives.ReduceFromModel.apply(x, mesh, axes),
                                         mesh, axes)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model`` (no gradient: callers detach it)."""
    mesh = tp()
    if mesh is None:
        return x
    from repro_torch.distributed import collectives

    return collectives.all_reduce(mesh, x.detach(), axes=("model",), op="max")


def require_dense(what: Optional[str] = None) -> None:
    """Raise for a path that tensor parallelism does not cover yet."""
    if tp() is not None:
        raise NotImplementedError(
            f"{what} on a mesh with model > 1 is not ported yet "
            "(ROADMAP queue 1, item 8: distributed)")
