"""Train <-> serve weight switching and weight-version tagging: the port of
``repro.distributed.weight_sync``.

In a colocated RL framework the same actor weights serve two engines with
different layouts: FSDP x TP for the train stage, TP-resident for the
generation stage (``sharding.param_specs`` modes). :func:`switch` is that
reshard among the ranks of a rank mesh (``collectives.repartition``: no
host round trip through a controller, no controller), and
:func:`switch_bytes` prices it: the bytes each device must receive once an
RL iteration.

In the staleness-bounded scheduler the trainer and the rollout side do not
share one implicit "current" set of weights: the trainer PUBLISHES a new
version after every update, and every rollout batch is tagged with the
version it was generated under, so the scheduler can measure and bound the
off-policy staleness (trainer version - behaviour version).

A published version is a copy. JAX arrays cannot change, so the JAX store
keeps the trainer's live pytree; the port's AdamW updates the parameters in
place (``optim/adamw.py``), so a store that kept the live tensors would see
every later step written into the version it calls published. ``publish``
therefore clones every leaf (strides kept), and drops its reference to the
previous version before it does, so that the store adds one copy of the
weights to the peak, not two. On a rank mesh the async worker publishes the
rank's own train-layout shards: a version is a clone of them (one rank's
share of one copy), and generation reaches the serve layout from it
through ``WorkerContext.serve_params`` of the behaviour state, one
:func:`switch` a dispatch.

``publish(mesh=, target_specs=)`` publishes through the train -> serve
switch, the version tag riding along. Port tensors carry no layout of their
own, so the specs the params lie under come with them (``specs=``; None:
whole on every rank).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shr


def switch(mesh, params, target_specs, *, specs=None) -> Any:
    """Reshard a param tree, this rank's shards under ``specs`` (None: whole
    on every rank), to the target stage layout (peer collectives). Values
    move bit for bit; a mesh without a world holds them whole already."""
    from repro_torch.distributed import collectives

    flat, unflatten = tree.flatten(params)
    src = [None] * len(flat) if specs is None else shr.spec_leaves(specs, params)
    dst = shr.spec_leaves(target_specs, params)
    return unflatten([collectives.repartition(mesh, p, d, s)
                      for p, s, d in zip(flat, src, dst)])


@dataclasses.dataclass(frozen=True)
class VersionedWeights:
    """A param tree plus the monotone version tag it was published under."""

    params: Any
    version: int


class WeightVersionStore:
    """Single-writer, monotone-version weight publication point.

    The trainer calls :meth:`publish` once per update; generation reads
    :attr:`current` (params + tag). Versions must strictly increase: a
    regression means two writers or a re-publish of stale weights, both of
    which would silently corrupt staleness accounting, so the store raises.
    """

    def __init__(self):
        self._current: Optional[VersionedWeights] = None

    @property
    def current(self) -> Optional[VersionedWeights]:
        return self._current

    @property
    def version(self) -> int:
        """The latest published version; -1 before the first publish."""
        return -1 if self._current is None else self._current.version

    def publish(self, params, *, version: Optional[int] = None, mesh=None,
                target_specs=None, specs=None) -> VersionedWeights:
        """Publish a copy of ``params`` under the next version (or an
        explicit one). ``None`` params publish the tag alone. With ``mesh``
        and ``target_specs`` the params (under ``specs``) are switched to the
        serve layout on the way (:func:`switch`)."""
        v = self.version + 1 if version is None else version
        if v <= self.version:
            raise ValueError(
                f"weight versions must be strictly monotone: got {v} after {self.version}")
        if target_specs is not None and mesh is None:
            raise ValueError("target_specs requires a mesh")
        self._current = None  # the previous copy goes before the new one is made
        if params is not None and target_specs is not None:
            params = switch(mesh, params, target_specs, specs=specs)
        snapshot = None if params is None else tree.map(lambda t: t.detach().clone(), params)
        self._current = VersionedWeights(params=snapshot, version=v)
        return self._current


def switch_bytes(cfg: ModelConfig, mesh, params_shape, src_mode: str = "train",
                 dst_mode: str = "serve") -> dict:
    """Analytic per-device cost of one train->serve switch: bytes each device
    must RECEIVE = its destination-resident bytes minus what it already holds
    under the source layout (overlap lower-bounds to the smaller shard)."""
    src = shr.param_specs(cfg, mesh, params_shape, mode=src_mode)
    dst = shr.param_specs(cfg, mesh, params_shape, mode=dst_mode)
    sizes = dict(mesh.shape)

    def shard_frac(spec, ndim):
        n = 1
        for axes in shr.dim_axes(spec, ndim):
            for a in axes:
                n *= sizes[a]
        return 1.0 / n

    recv = total_dst = 0.0
    for leaf, s_spec, d_spec in zip(tree.leaves(params_shape), shr.spec_leaves(src),
                                    shr.spec_leaves(dst)):
        nbytes = leaf.numel() * leaf.element_size()
        f_src = shard_frac(s_spec, leaf.dim())
        f_dst = shard_frac(d_spec, leaf.dim())
        total_dst += nbytes * f_dst
        recv += nbytes * max(f_dst - min(f_src, f_dst), 0.0)
    return {
        "recv_bytes_per_device": recv,
        "resident_bytes_per_device_dst": total_dst,
        # at the JAX package's assumed interconnect rate (3 links x 50 GB/s)
        "switch_seconds": recv / 150e9,
    }
