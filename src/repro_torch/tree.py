"""Nested containers of tensors (the port's stand-in for ``jax.tree``).

Params, gradients and optimizer moments are nested dicts, lists and tuples
with tensors at the leaves, walked in one fixed order: dict keys as inserted,
sequences (NamedTuples such as ``TrainState`` included) by index. ``None``
is a leaf like any other. :func:`jax_order` gives the permutation into
``jax.tree_util``'s order, which walks dict keys sorted.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in walk order."""
    return [leaf for _, leaf in leaves_with_keys(tree)]


def leaves_with_keys(tree, sort_keys: bool = False) -> List[Tuple[str, Any]]:
    """(key, leaf) for the leaves of ``tree`` in walk order (dict keys sorted
    with ``sort_keys``). A leaf's key is the string ``jax.tree_util.keystr``
    gives for the same path: ``['name']`` for a dict key, ``[i]`` for a list
    or tuple item, ``.field`` for a NamedTuple field; so a tree of the same
    structure has the same keys in both packages."""
    out: List[Tuple[str, Any]] = []

    def walk(t, key):
        if isinstance(t, dict):
            for k in (sorted(t) if sort_keys else t):
                walk(t[k], f"{key}[{k!r}]")
        elif isinstance(t, (list, tuple)):
            fields = getattr(t, "_fields", None)
            for i, v in enumerate(t):
                walk(v, f"{key}.{fields[i]}" if fields else f"{key}[{i}]")
        else:
            out.append((key, t))

    walk(tree, "")
    return out


def jax_order(tree) -> List[int]:
    """The walk-order positions of the leaves of ``tree`` in
    ``jax.tree_util``'s leaf order (dict keys sorted at every level):
    ``[leaves(tree)[i] for i in jax_order(tree)]``. A wire format shared
    with the JAX package lays its leaves out in this order."""
    pos = {k: i for i, (k, _) in enumerate(leaves_with_keys(tree))}
    return [pos[k] for k, _ in leaves_with_keys(tree, sort_keys=True)]


def flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves, unflatten): ``unflatten(new_leaves)`` rebuilds a tree of the
    same structure from leaves in walk order."""
    flat = leaves(tree)

    def unflatten(new_leaves):
        it = iter(new_leaves)

        def build(t):
            if isinstance(t, dict):
                return {k: build(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                built = [build(v) for v in t]
                # a NamedTuple takes its fields as positional arguments
                return type(t)(*built) if hasattr(t, "_fields") else type(t)(built)
            return next(it)

        return build(tree)

    return flat, unflatten


def map(fn: Callable, tree, *rest):  # noqa: A001 - mirrors jax.tree.map
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure),
    leaf by leaf, into a tree of ``tree``'s structure."""
    flat, unflatten = flatten(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"trees of {len(flat)} and {len(o)} leaves")
    return unflatten([fn(*xs) for xs in zip(flat, *others)])
