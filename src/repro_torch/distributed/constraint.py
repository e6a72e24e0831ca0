"""The ambient rank mesh of the model code: the port of
``repro.distributed.constraint``.

JAX's model code annotates activations with logical entries ('dp', 'tp')
and the ambient mesh (``use_mesh``) resolves them for GSPMD, which inserts
the collectives. The port has no GSPMD: each rank computes on its own shards
and the model code calls the collectives itself, at the same call sites.
So the ambient mesh here is a rank mesh, set with :func:`use_mesh` (the DAG
worker enters its context's mesh for every iteration), and the helpers
below are what the model code asks of it:

- :func:`tp` is the ambient mesh when it splits ``model`` over more than one
  rank of a ``torch.distributed`` world, else None. Without such a mesh
  every helper is a no-op, so the model code stays mesh-agnostic, as in
  JAX, and one device takes exactly its old path;
- :func:`copy_to_model`, :func:`reduce_from_model` and
  :func:`gather_from_model` are the Megatron region operators over the
  ``model`` group (``distributed.collectives``).

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
