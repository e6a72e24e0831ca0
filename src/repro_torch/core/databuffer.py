"""Distributed Databuffer (paper §6.2, Figs. 7-8) on one device: the port of
``repro.core.databuffer``.

One buffer instance per process. Stage outputs are stored as tensors on the
run's device, each under the spec its producing stage put it with; nothing is
gathered to a controller.

At a stage boundary the consumer asks for a key under ITS spec:
  * the spec matches how the value was put: **fast path**, the same tensor is
    handed over;
  * the spec differs: a **redistribution**. On a JAX mesh this is the
    all-to-all of Fig. 7. On one device every destination slice is already
    resident, so the same tensor is handed over and ``bytes_moved`` stays 0,
    as the JAX buffer reckons a reshard on a 1x1 mesh. The counts are kept
    all the same, so they equal the JAX buffer's on the same DAG.

A spec is a tuple of axis entries, one per leading dimension: ``("data",
None)``, ``(("data", "model"),)``; an entry is an axis name, a tuple of axis
names, or None. Specs are compared as :func:`_normalize` canonicalises them,
as the JAX buffer compares ``PartitionSpec``s.

:class:`CentralizedDatabuffer` is the single-controller baseline: every put
is copied to host memory and every get copied back to the device, a real
device-to-host round trip on the card.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

Spec = Tuple[Any, ...]


class DeviceMesh:
    """The placement that stands in for a JAX ``Mesh`` on an explicit
    ``torch.device``: named axes with sizes, ``("data", "model") = (1, 1)``
    by default. A fleet host's mesh is ``launch.mesh.make_fleet_mesh``'s
    ``("pod", "data", "model") = (num_hosts, 1, 1)``: the global fleet as
    JAX's fleet mesh reads, of which this process holds its host's one
    device."""

    def __init__(self, device, shape: Optional[Dict[str, int]] = None):
        self.device = torch.device(device)
        self._shape = dict(shape) if shape is not None else {"data": 1, "model": 1}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._shape)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.device}, shape={self.shape})"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class BufferStats:
    puts: int = 0
    fast_path_hits: int = 0
    redistributions: int = 0
    bytes_moved: int = 0  # bytes crossing device boundaries in redistributions
    bytes_through_controller: int = 0  # always 0 for the distributed buffer
    # per-destination-host inbound bytes (host index -> bytes); on one device
    # only the centralized buffer's controller (host 0) receives any
    host_inbound_bytes: Dict[int, int] = field(default_factory=dict)
    # double-buffer accounting (DoubleBufferedDatabuffer only):
    overlap_hits: int = 0  # gets served by a reshard issued ahead of time
    sync_waits: int = 0  # gets that had to issue the reshard on the spot
    rotations: int = 0  # iteration boundaries (slot swaps)

    @property
    def max_host_inbound_bytes(self) -> int:
        return max(self.host_inbound_bytes.values(), default=0)

    def reset(self):
        self.puts = self.fast_path_hits = self.redistributions = 0
        self.bytes_moved = self.bytes_through_controller = 0
        self.host_inbound_bytes = {}
        self.overlap_hits = self.sync_waits = self.rotations = 0


def _normalize(spec: Spec, ndim: int) -> tuple:
    """Pad with None to ndim and canonicalize single-axis tuples, so
    ("data",), ("data", None) and (("data",), None) all compare equal."""
    parts = list(spec) + [None] * (ndim - len(spec))
    out = []
    for p in parts:
        if isinstance(p, tuple):
            p = p[0] if len(p) == 1 else p
        out.append(p)
    return tuple(out)


class DistributedDatabuffer:
    """Parallelism-aware intermediary between RL stages."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self._store: Dict[str, torch.Tensor] = {}
        self._specs: Dict[str, Optional[tuple]] = {}  # key -> normalized put spec
        self.stats = BufferStats()

    # ------------------------------------------------------------------ #
    def put(self, key: str, value: torch.Tensor, spec: Optional[Spec] = None) -> None:
        """Store a stage output on the mesh's device under ``spec`` (None:
        no spec, so every later get under a spec is a redistribution, as for
        a JAX array without a named sharding)."""
        value = value.to(self.mesh.device)
        self._store[key] = value
        self._specs[key] = None if spec is None else _normalize(spec, value.ndim)
        self.stats.puts += 1

    def get(self, key: str, spec: Optional[Spec] = None) -> torch.Tensor:
        """Fetch under the consumer stage's spec (None = as stored)."""
        value = self._store[key]
        if spec is None:
            return value
        if self._matches(key, spec):
            self.stats.fast_path_hits += 1  # DP unchanged: zero-copy handoff
            return value
        # one device: every target slice is resident, nothing moves
        self.stats.redistributions += 1
        return value

    def spec_of(self, key: str) -> Optional[tuple]:
        """The normalized spec ``key`` was put under (None if none)."""
        return self._specs.get(key)

    def keys(self):
        return list(self._store)

    def pop(self, key: str) -> torch.Tensor:
        self._specs.pop(key, None)
        return self._store.pop(key)

    def clear(self) -> None:
        self._store.clear()
        self._specs.clear()

    # ------------------------------------------------------------------ #
    def _matches(self, key: str, spec: Spec) -> bool:
        stored = self._specs.get(key)
        if stored is None:
            return False
        return stored == _normalize(spec, self._store[key].ndim)


class DoubleBufferedDatabuffer(DistributedDatabuffer):
    """Asynchronous double buffer (paper §6.2: "local caching, load balancing,
    and asynchronous double buffer").

    Two rotating slots decouple producer and consumer iterations: ``clear()``
    at an iteration boundary *rotates* instead of dropping, so the retired
    slot's tensors stay referenced while iteration i+1's producers fill the
    other slot.

    On top of the slots sits spec prefetch: the buffer records, per key, the
    specs consumers have requested (iteration 0 is the recording pass). From
    then on every ``put`` stages the value toward each recorded consumer
    spec, and ``get`` finds it staged: ``overlap_hits`` counts those,
    ``sync_waits`` the gets that had to reshard on the spot (first
    iteration, or a never-seen spec). On one device a staged reshard is the
    stored tensor itself, so values are bitwise those of the synchronous
    path and the counts are the JAX buffer's.
    """

    def __init__(self, mesh: DeviceMesh):
        super().__init__(mesh)
        self._slots = [{}, {}]
        self._spec_slots = [{}, {}]
        self._staged_slots = [{}, {}]  # (key, norm_spec) -> staged tensor
        self._active = 0
        self._store = self._slots[0]
        self._specs = self._spec_slots[0]
        self._staged = self._staged_slots[0]
        # key -> {normalized spec -> spec} learned from consumers
        self._consumer_specs: Dict[str, Dict[tuple, Spec]] = {}
        self._staging_paused = False

    # ------------------------------------------------------------------ #
    def put(self, key: str, value: torch.Tensor, spec: Optional[Spec] = None) -> None:
        # drop any staged reshard of a previous value under this key
        for sk in [sk for sk in self._staged if sk[0] == key]:
            del self._staged[sk]
        super().put(key, value, spec)
        self._stage(key)

    def prefetch(self, key: str, spec: Spec) -> None:
        """Explicitly pre-declare a consumer spec (optional API: the learned
        path makes this unnecessary after the first iteration)."""
        stored = self._store.get(key)
        if stored is None:
            return
        norm = _normalize(spec, stored.ndim)
        self._consumer_specs.setdefault(key, {})[norm] = spec
        self._stage(key)

    @contextlib.contextmanager
    def staging_paused(self):
        """Suspend put-time staging, then stage the final contents once on
        exit. Used by the worker around stages that rewrite their own outputs
        (the load-balance repack re-puts every rollout key), so each key is
        staged once, for the value consumers will read."""
        self._staging_paused = True
        try:
            yield
        finally:
            self._staging_paused = False
            for key in list(self._store):
                self._stage(key)

    def _stage(self, key: str) -> None:
        """Stage ``key`` toward every recorded consumer spec that differs from
        the one it was put under."""
        if self._staging_paused:
            return
        value = self._store[key]
        for norm, spec in self._consumer_specs.get(key, {}).items():
            if self._matches(key, spec) or (key, norm) in self._staged:
                continue
            self.stats.redistributions += 1
            self._staged[(key, norm)] = value

    def get(self, key: str, spec: Optional[Spec] = None) -> torch.Tensor:
        value = self._store[key]
        if spec is None:
            return value
        norm = _normalize(spec, value.ndim)
        self._consumer_specs.setdefault(key, {})[norm] = spec
        if self._matches(key, spec):
            self.stats.fast_path_hits += 1
            return value
        staged = self._staged.get((key, norm))
        if staged is not None:
            self.stats.overlap_hits += 1  # staged ahead of the get
            return staged
        self.stats.sync_waits += 1
        self.stats.redistributions += 1
        self._staged[(key, norm)] = value  # serve repeat gets from the cache
        return value

    def pop(self, key: str) -> torch.Tensor:
        for sk in [sk for sk in self._staged if sk[0] == key]:
            del self._staged[sk]
        return super().pop(key)

    def rotate(self) -> None:
        """Iteration boundary: swap slots; the new active slot starts empty
        while the retired slot keeps its references alive."""
        self._active ^= 1
        self._store = self._slots[self._active]
        self._specs = self._spec_slots[self._active]
        self._staged = self._staged_slots[self._active]
        self._store.clear()
        self._specs.clear()
        self._staged.clear()
        self.stats.rotations += 1

    def clear(self) -> None:
        # the worker calls clear() at the end of an iteration; for the double
        # buffer that is a rotation, not a drop
        self.rotate()


class CentralizedDatabuffer(DistributedDatabuffer):
    """The single-controller baseline arm (paper Fig. 2, the verl-style
    hybrid-controller dataflow): every stage output is copied to the
    controller's host memory and dispatched back to the device from there.
    Functionally identical; the all-to-one / one-to-all traffic and the
    controller-resident bytes are what the paper identifies as the scaling
    bottleneck.

    Unlike the JAX baseline, whose ``keys()`` lists only the (always empty)
    device store, ``keys()`` here lists what the controller holds, so a stage
    that asks whether a key exists (the actor step's ``ref_logprob``) sees
    the same keys on every arm."""

    def __init__(self, mesh: DeviceMesh):
        super().__init__(mesh)
        self._host_store: Dict[str, torch.Tensor] = {}
        self.controller_resident_bytes = 0  # peak bytes held by the controller

    def put(self, key: str, value: torch.Tensor, spec: Optional[Spec] = None) -> None:
        # all-to-one: the controller holds the full global batch in host memory
        host_value = value.to("cpu", copy=True)
        nbytes = _nbytes(host_value)
        self.stats.bytes_through_controller += nbytes
        self.stats.host_inbound_bytes[0] = self.stats.host_inbound_bytes.get(0, 0) + nbytes
        self._host_store[key] = host_value
        self.controller_resident_bytes = max(
            self.controller_resident_bytes,
            sum(_nbytes(v) for v in self._host_store.values()))
        self.stats.puts += 1

    def get(self, key: str, spec: Optional[Spec] = None) -> torch.Tensor:
        # one-to-all: the controller dispatches to the consumer
        host_value = self._host_store[key]
        self.stats.bytes_through_controller += _nbytes(host_value)
        self.stats.redistributions += 1
        return host_value.to(self.mesh.device, copy=True)

    def keys(self):
        return list(self._host_store)

    def pop(self, key: str) -> torch.Tensor:
        return self._host_store.pop(key).to(self.mesh.device, copy=True)

    def clear(self) -> None:
        super().clear()
        self._host_store.clear()
