"""Weight-version tagging for the async off-policy pipeline: the port of the
version store of ``repro.distributed.weight_sync``.

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
previous version before it does, so that on one device the store adds one
copy of the weights to the peak, not two.

The train -> serve reshard that JAX threads through ``publish(mesh=...,
target_specs=...)`` (``switch``, ``switch_bytes``) goes through the
multi-device sharding layer, ROADMAP queue 1, item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch import tree


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
                target_specs=None) -> VersionedWeights:
        """Publish a copy of ``params`` under the next version (or an
        explicit one). ``None`` params publish the tag alone."""
        v = self.version + 1 if version is None else version
        if v <= self.version:
            raise ValueError(
                f"weight versions must be strictly monotone: got {v} after {self.version}")
        if mesh is not None or target_specs is not None:
            raise NotImplementedError(
                "publishing through the train -> serve reshard is not ported yet "
                "(ROADMAP queue 1, item 8: distributed)")
        self._current = None  # the previous copy goes before the new one is made
        snapshot = None if params is None else tree.map(lambda t: t.detach().clone(), params)
        self._current = VersionedWeights(params=snapshot, version=v)
        return self._current
