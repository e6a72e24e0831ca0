"""Sharding rules: FSDP x TP specs for every architecture, the port of
``repro.distributed.sharding``.

A spec is a tuple with one entry a leading tensor dimension: an axis name,
a tuple of axis names (one dimension split over several axes, the first the
outermost) or ``None`` (not split), equal entry for entry to the JAX
package's ``PartitionSpec``. The rules read only a mesh's ``shape`` and
``axis_names``, so they run at the production meshes
(``launch.mesh.make_production_mesh``) with no world behind them.

Param rules are name-based over the last two dims (stacked leading dims,
layer groups and experts, are left-padded with None / FSDP as divisibility
allows). Conventions:

  * TP over `model`: attention heads (padded to 16), d_ff, SSD heads, vocab.
  * FSDP over (`pod`, `data`): the d_model-sized dim of every matrix, so
    params + optimizer state scale 1/(pod*data), ZeRO-3 semantics.
  * GQA kv_heads < tp: K/V projections replicated over `model` (the decode
    cache is sequence-sharded over `model` instead).
  * MoE expert dim (8/16/40, never 16-divisible): experts replicated over
    `model`, their f dim TP-sharded ("expert tensor parallelism").
  * batch < dp (long_500k B=1): batch replicated, decode caches
    context-sharded over ALL axes.

:func:`named` maps a spec onto ``torch.distributed.tensor`` placements, one
``Shard(d)`` or ``Replicate()`` a mesh dimension; the rank mesh's
collectives (``distributed.collectives``) move data by those placements.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig

Spec = Tuple[Any, ...]


def P(*entries) -> Spec:
    """A spec as JAX's ``PartitionSpec`` canonicalises it: a one-axis tuple
    entry becomes the axis name, an empty one None."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    s = 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        s *= mesh.shape[a]
    return s


def _divisible(n: int, mesh, axes) -> bool:
    return not axes or n % _size(mesh, axes) == 0


def _maybe(n: int, mesh, axes):
    """axes if they divide n else None (replicate)."""
    return axes if _divisible(n, mesh, axes) else None


# --------------------------------------------------------------------------- #
# param specs
# --------------------------------------------------------------------------- #
def _base_rule(cfg: ModelConfig, mesh, name: str, shape, mode: str = "train") -> Tuple:
    """Spec entries for the TRAILING dims that the rule understands; leading
    (stack) dims are padded by the caller.

    mode="serve": decode weights stay TP-sharded over `model` but REPLICATED
    over the data axes (no FSDP), so that a decode step does not all-gather
    the FSDP-sharded weights every token."""
    if mode == "serve":
        tp_all = ("model",)
        if name == "embed":  # (V, d)
            return (_maybe(shape[0], mesh, tp_all), None)
        if name in ("w_q", "w_dt", "w_k", "w_v", "w_in", "w_gate", "w_z", "w_x", "lm_head"):
            return (None, _maybe(shape[-1], mesh, tp_all))
        if name in ("w_o", "w_out"):
            return (_maybe(shape[-2], mesh, tp_all), None)
        if name in ("b_q", "b_k", "b_v", "b_in"):
            return (_maybe(shape[-1], mesh, tp_all),)
        if name in ("A_log", "D", "dt_bias", "norm_w"):
            return (_maybe(shape[-1], mesh, tp_all),)
        if name == "conv_x":
            return (None, _maybe(shape[-1], mesh, tp_all))
        if name in ("w_B", "w_C", "router", "conv_bc", "b_o", "b_out", "w", "b", "v_head"):
            return tuple(None for _ in shape[-2:]) if len(shape) >= 2 else (None,)
        return tuple(None for _ in shape)

    fsdp = fsdp_axes(mesh)
    tp_ok_kv = cfg.num_kv_heads and _divisible(cfg.num_kv_heads, mesh, ("model",))
    if name == "embed":  # (V, d)
        return (_maybe(shape[0], mesh, "model"), _maybe(shape[1], mesh, fsdp))
    if name == "lm_head":  # (d, V)
        return (_maybe(shape[-2], mesh, fsdp), _maybe(shape[-1], mesh, "model"))
    if name == "v_head":  # (d, 1)
        return (_maybe(shape[-2], mesh, fsdp), None)
    if name in ("w_q", "w_dt"):  # (d, Hp*hd) / (d, nh)
        return (_maybe(shape[-2], mesh, fsdp), _maybe(shape[-1], mesh, "model"))
    if name in ("w_k", "w_v"):  # (d, kvh*hd): TP only when kvh | tp
        return (_maybe(shape[-2], mesh, fsdp), "model" if tp_ok_kv else None)
    if name == "w_o":  # (Hp*hd, d)
        return (_maybe(shape[-2], mesh, "model"), _maybe(shape[-1], mesh, fsdp))
    if name in ("w_in", "w_gate", "w_z", "w_x"):  # (d, f) / (d, din)
        return (_maybe(shape[-2], mesh, fsdp), _maybe(shape[-1], mesh, "model"))
    if name == "w_out":  # (f|din, d)
        return (_maybe(shape[-2], mesh, "model"), _maybe(shape[-1], mesh, fsdp))
    if name in ("w_B", "w_C"):  # (d, g*n): tiny, replicate cols
        return (_maybe(shape[-2], mesh, fsdp), None)
    if name == "router":  # (d, E)
        return (_maybe(shape[-2], mesh, fsdp), None)
    if name == "conv_x":  # (kw, din)
        return (None, _maybe(shape[-1], mesh, "model"))
    if name == "conv_bc":
        return (None, None)
    if name in ("A_log", "D", "dt_bias", "norm_w"):  # (nh,) / (din,)
        return (_maybe(shape[-1], mesh, "model"),)
    if name in ("b_q", "b_in"):  # (Hp*hd,) / (f,)
        return (_maybe(shape[-1], mesh, "model"),)
    if name in ("b_k", "b_v"):
        return ("model" if tp_ok_kv and _divisible(shape[-1], mesh, "model") else None,)
    if name in ("b_o", "b_out", "w", "b"):  # biases to d / norm scales
        return (None,)
    return tuple(None for _ in shape)  # fallback: replicate


def _map_with_path(fn, tree, path=()):
    """``fn(keys, leaf)`` over the leaves of a nested dict / list / tuple,
    where ``keys`` are the dict keys on the way to the leaf (as JAX's
    ``DictKey`` entries of a path); a leaf of ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        built = [_map_with_path(fn, v, path) for v in tree]
        return type(tree)(*built) if hasattr(tree, "_fields") else type(tree)(built)
    return None if tree is None else fn(path, tree)


def param_specs(cfg: ModelConfig, mesh, params_shape, mode: str = "train") -> Any:
    """Tree of specs matching ``params_shape`` (tensors, on the ``meta``
    device or any other). mode: "train" (FSDP x TP) | "serve" (TP only,
    weights replicated over the data axes)."""
    fsdp = fsdp_axes(mesh)

    def rule(keys, leaf):
        name = keys[-1] if keys else None
        shape = tuple(leaf.shape)
        if "moe" in keys and name in ("w_in", "w_gate", "w_out") and mode == "train":
            # (..., E, d, f) or (..., E, f, d): expert dim at -3
            base = _base_rule(cfg, mesh, name, shape)
            if _divisible(shape[-3], mesh, fsdp):
                # FSDP the expert dim; drop fsdp from the trailing dims
                base = tuple(None if b == fsdp else b for b in base)
                lead = [None] * (len(shape) - 3) + [fsdp]
            else:
                lead = [None] * (len(shape) - 2)
            return P(*lead, *base)
        base = _base_rule(cfg, mesh, name, shape, mode)
        return P(*[None] * (len(shape) - len(base)), *base)

    return _map_with_path(rule, params_shape)


# --------------------------------------------------------------------------- #
# batch / cache specs
# --------------------------------------------------------------------------- #
def batch_axes(mesh, global_batch: int):
    """Largest prefix of the data axes that divides the batch."""
    axes = []
    size = 1
    for a in fsdp_axes(mesh):
        if global_batch % (size * mesh.shape[a]) == 0:
            axes.append(a)
            size *= mesh.shape[a]
    return tuple(axes) or None


def train_batch_specs(cfg: ModelConfig, mesh, global_batch: int) -> Dict[str, Spec]:
    dp = batch_axes(mesh, global_batch)
    specs = {"tokens": P(dp, None), "labels": P(dp, None)}
    if cfg.is_encoder_decoder:
        specs["frames"] = P(dp, None, None)
    if cfg.num_prefix_embeds > 1:
        specs["prefix_embeds"] = P(dp, None, None)
    return specs


def cache_specs(cfg: ModelConfig, mesh, batch: int, caches_shape) -> Any:
    """Decode caches: batch over data axes; KV sequence over `model`.
    B=1 (long_500k): context over ALL axes instead."""
    dp = batch_axes(mesh, batch)
    ctx_axes = ("model",) if dp else tuple(mesh.axis_names)

    def rule(keys, leaf):
        name = keys[-1] if keys else None
        shape = tuple(leaf.shape)
        if name in ("k", "v", "mk", "mv"):  # (N, B, W, KVH, hd)
            seq_ax = ctx_axes if shape[-3] % _size(mesh, ctx_axes) == 0 else None
            return P(*[None] * (len(shape) - 4), dp, seq_ax, None, None)
        if name in ("k_scale", "v_scale"):  # (N, B, W, KVH)
            seq_ax = ctx_axes if shape[-2] % _size(mesh, ctx_axes) == 0 else None
            return P(*[None] * (len(shape) - 3), dp, seq_ax, None)
        if name == "ssm":  # (N, B, nh, hd, ds)
            nh_ax = "model" if shape[-3] % mesh.shape["model"] == 0 else None
            return P(*[None] * (len(shape) - 4), dp, nh_ax, None, None)
        if name in ("conv_x", "conv_bc"):  # (N, B, kw-1, C)
            c_ax = "model" if shape[-1] % mesh.shape["model"] == 0 else None
            return P(*[None] * (len(shape) - 3), dp, None, c_ax)
        return tuple(None for _ in shape)

    return _map_with_path(rule, caches_shape)


def opt_state_specs(pspecs) -> Any:
    """AdamW state mirrors params: (step (), m/v like params)."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(step=(), m=pspecs, v=pspecs)


def is_spec(x) -> bool:
    """A spec, not a container of specs: a tuple of axis entries (str,
    tuple of str, or None), or the empty tuple."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def spec_leaves(specs, like=None) -> list:
    """The specs of a tree of specs, in walk order (the tree's own walk:
    dicts as inserted, sequences by index); with ``like``, a tree of the
    same structure (the params the specs describe), in ``like``'s walk
    order, each spec found by its key: two trees of one structure may hold
    their dict keys in different orders (params bridged from JAX)."""
    if is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        keys = specs if like is None else like
        return [s for k in keys
                for s in spec_leaves(specs[k], None if like is None else like[k])]
    if isinstance(specs, (list, tuple)):
        likes = [None] * len(specs) if like is None else like
        return [s for v, lk in zip(specs, likes) for s in spec_leaves(v, lk)]
    return [specs]


def map_with_specs(fn, params, specs):
    """``fn(leaf, spec)`` over the leaves of ``params`` and the specs of a
    spec tree of the same structure, into a tree of ``params``' structure
    (``tree.map`` would walk into the specs' tuples)."""
    from repro_torch import tree

    flat, unflatten = tree.flatten(params)
    sl = spec_leaves(specs, params)
    if len(sl) != len(flat):
        raise ValueError(f"{len(sl)} specs for {len(flat)} leaves")
    return unflatten([fn(p, s) for p, s in zip(flat, sl)])


def dim_axes(spec: Optional[Spec], ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """For each of ``ndim`` tensor dims, the axes that split it, outermost
    first (``()`` for a dim not split)."""
    spec = tuple(spec or ()) + (None,) * ndim
    out = []
    for e in spec[:ndim]:
        out.append(() if e is None else (e,) if isinstance(e, str) else tuple(e))
    return tuple(out)


def named(mesh, spec: Spec, ndim: Optional[int] = None) -> Tuple[Any, ...]:
    """``spec`` as ``torch.distributed.tensor`` placements over ``mesh``:
    ``Shard(d)`` on each mesh dim that splits tensor dim ``d``,
    ``Replicate()`` on the others. A dim split over several axes lists them
    in the mesh's order (the first the outermost, as JAX reads the tuple)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.axis_names)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(dim_axes(spec, len(spec) if ndim is None else ndim)):
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} splits two dims")
            out[i] = Shard(d)
    return tuple(out)
