"""Distributed Databuffer (paper §6.2, Figs. 7-8): the port of
``repro.core.databuffer``.

One buffer instance per process. Stage outputs are stored as tensors on the
run's device, each under the spec its producing stage put it with; nothing is
gathered to a controller. On a rank mesh (one process a device over
``torch.distributed``) each rank's buffer holds that rank's shard.

At a stage boundary the consumer asks for a key under ITS spec:
  * the spec matches how the value was put: **fast path**, the same tensor is
    handed over;
  * the spec differs: a **redistribution**. On a rank mesh the shard moves
    to the consumer's layout among the ranks
    (``distributed.collectives.repartition``; no central node takes part),
    and the destination slices not yet resident on their host are charged
    to ``bytes_moved`` and ``host_inbound_bytes`` as the JAX buffer charges
    them. On one device every destination slice is already resident, so the
    same tensor is handed over and ``bytes_moved`` stays 0, as the JAX
    buffer reckons a reshard on a 1x1 mesh. The counts are kept all the
    same, so they equal the JAX buffer's on the same DAG.

A spec is a tuple of axis entries, one per leading dimension: ``("data",
None)``, ``(("data", "model"),)``; an entry is an axis name, a tuple of axis
names, or None. Specs are compared as :func:`_normalize` canonicalises them,
as the JAX buffer compares ``PartitionSpec``s.

:class:`CentralizedDatabuffer` is the single-controller baseline: every put
is copied to host memory and every get copied back to the device, a real
device-to-host round trip on the card; on a rank mesh every put is gathered
to rank 0 and every get sent out from it.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

Spec = Tuple[Any, ...]


class DeviceMesh:
    """The placement that stands in for a JAX ``Mesh``: named axes with
    sizes, ``("data", "model") = (1, 1)`` by default, on an explicit
    ``torch.device``.

    - One device: ``DeviceMesh(device)``.
    - A file-plane fleet host (``launch.mesh.make_fleet_mesh`` without a
      ``torch.distributed`` world): ``("pod", "data", "model") =
      (num_hosts, 1, 1)``, the global fleet as JAX's fleet mesh reads, of
      which this process holds its host's one device.
    - A rank mesh (``launch.mesh.make_fleet_mesh`` / ``make_local_mesh`` in a
      world of more than one rank): one rank a device, numbered row-major
      over the axes, as a JAX mesh numbers its devices. ``torch_mesh`` is the
      ``torch.distributed.device_mesh.DeviceMesh`` whose per-axis groups the
      collectives run over, and ``coords`` this rank's coordinate on each
      axis.
    - A shape-only mesh (``device`` None): what the sharding rules read at
      the production meshes, with no world behind it.
    """

    def __init__(self, device, shape: Optional[Dict[str, int]] = None, *, torch_mesh=None):
        self.device = None if device is None else torch.device(device)
        self._shape = dict(shape) if shape is not None else {"data": 1, "model": 1}
        self.torch_mesh = torch_mesh
        self.rank = 0
        if torch_mesh is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank()

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._shape)

    @property
    def num_ranks(self) -> int:
        """Processes the mesh's devices are spread over (1 without a world)."""
        return math.prod(self._shape.values()) if self.torch_mesh is not None else 1

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis (all 0 without a world)."""
        return rank_coords(self._shape, self.rank)

    def __repr__(self) -> str:
        ranks = f", rank={self.rank} of {self.num_ranks}" if self.torch_mesh is not None else ""
        return f"DeviceMesh({self.device}, shape={self.shape}{ranks})"


def rank_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Row-major coordinates of ``rank`` over the axes of ``shape``."""
    out = {}
    for name in reversed(tuple(shape)):
        rank, out[name] = divmod(rank, shape[name])
    return {name: out[name] for name in shape}


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
        """Store a stage output on the mesh's device under ``spec``: on a
        rank mesh, this rank's shard of it (None: no spec, every rank holds
        the value whole, and every later get under a spec is a
        redistribution, as for a JAX array without a named sharding)."""
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
        return self._reshard(key, spec)

    def spec_of(self, key: str) -> Optional[tuple]:
        """The normalized spec ``key`` was put under (None if none)."""
        return self._specs.get(key)

    def global_value(self, key: str) -> torch.Tensor:
        """``key``'s global value, on every rank (gathered from the shards on
        a rank mesh, outside the stage-boundary accounting, as a JAX stage
        reads a global array; on one device, ``get(key)``)."""
        if self.mesh.torch_mesh is None:
            return self.get(key)
        from repro_torch.distributed import collectives

        return collectives.all_gather(self.mesh, self._store[key], self._specs.get(key))

    def keys(self):
        return list(self._store)

    def pop(self, key: str) -> torch.Tensor:
        self._specs.pop(key, None)
        return self._store.pop(key)

    def clear(self) -> None:
        self._store.clear()
        self._specs.clear()

    # ------------------------------------------------------------------ #
    def _reshard(self, key: str, spec: Spec) -> torch.Tensor:
        """One redistribution of ``key`` to the consumer's ``spec``: counted,
        charged, and on a rank mesh moved."""
        self.stats.redistributions += 1
        value = self._store[key]
        if self.mesh.torch_mesh is None:
            return value  # one device: every target slice is resident
        from repro_torch.distributed import collectives

        src = self._specs.get(key)
        self._account_reshard(collectives.global_shape(self.mesh, value.shape, src),
                              value.element_size(), src, spec)
        return collectives.repartition(self.mesh, value, spec, src)

    def _account_reshard(self, shape, itemsize: int, src, dst) -> None:
        """Charge one redistribution's traffic to its destination hosts (the
        rows of the mesh's ``pod`` axis; a mesh without one is one host), as
        the JAX buffer does: for each destination rank the bytes of its
        target slice, once per (host, slice), and none for a slice that some
        rank of the same host already holds under the source spec."""
        from repro_torch.distributed import collectives

        shape_map = self.mesh.shape
        n = math.prod(shape_map.values())

        def key_of(region):
            return tuple((sl.start, sl.stop) for sl in region)

        resident: Dict[int, set] = {}
        targets = []
        for r in range(n):
            c = rank_coords(shape_map, r)
            h = c.get("pod", 0)
            resident.setdefault(h, set()).add(key_of(collectives.region(self.mesh, shape, src, c)))
            targets.append((h, collectives.region(self.mesh, shape, dst, c)))
        seen: Dict[int, set] = {}
        moved = 0
        for h, reg in targets:
            k = key_of(reg)
            if k in seen.setdefault(h, set()):
                continue  # replicated copy on the same host: one transfer
            seen[h].add(k)
            if k in resident.get(h, set()):
                continue  # already resident on this host
            b = itemsize * math.prod(sl.stop - sl.start for sl in reg)
            moved += b
            self.stats.host_inbound_bytes[h] = self.stats.host_inbound_bytes.get(h, 0) + b
        self.stats.bytes_moved += moved

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
    iteration, or a never-seen spec). On a rank mesh the staged reshard
    moves the shard at the put, ahead of the get; on one device it is the
    stored tensor itself. Values are bitwise those of the synchronous path
    and the counts are the JAX buffer's.
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
        for norm, spec in self._consumer_specs.get(key, {}).items():
            if self._matches(key, spec) or (key, norm) in self._staged:
                continue
            self._staged[(key, norm)] = self._reshard(key, spec)

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
        out = self._reshard(key, spec)
        self._staged[(key, norm)] = out  # serve repeat gets from the cache
        return out

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
    On a rank mesh the controller is rank 0: a put gathers the global value
    there (every rank's shard), and a get sends it out from there to every
    rank, which keeps its shard under the consumer's spec. Functionally
    identical; the all-to-one / one-to-all traffic and the
    controller-resident bytes are what the paper identifies as the scaling
    bottleneck. Every rank counts the same global bytes.

    Unlike the JAX baseline, whose ``keys()`` lists only the (always empty)
    device store, ``keys()`` here lists what the controller holds, so a stage
    that asks whether a key exists (the actor step's ``ref_logprob``) sees
    the same keys on every arm."""

    def __init__(self, mesh: DeviceMesh):
        super().__init__(mesh)
        # key -> the global value (on the controller) or its (shape, dtype)
        self._host_store: Dict[str, Any] = {}
        self.controller_resident_bytes = 0  # peak bytes held by the controller

    def _controller(self) -> bool:
        return self.mesh.rank == 0

    def put(self, key: str, value: torch.Tensor, spec: Optional[Spec] = None) -> None:
        # all-to-one: the controller holds the full global batch in host memory
        if self.mesh.torch_mesh is not None:
            from repro_torch.distributed import collectives

            norm = None if spec is None else _normalize(spec, value.ndim)
            value = collectives.all_gather(self.mesh, value, norm)
        host_value = value.to("cpu", copy=True)
        nbytes = _nbytes(host_value)
        self.stats.bytes_through_controller += nbytes
        self.stats.host_inbound_bytes[0] = self.stats.host_inbound_bytes.get(0, 0) + nbytes
        self._host_store[key] = (host_value if self._controller()
                                 else (host_value.shape, host_value.dtype))
        self.controller_resident_bytes = max(
            self.controller_resident_bytes,
            sum(math.prod(v[0]) * v[1].itemsize if isinstance(v, tuple) else _nbytes(v)
                for v in self._host_store.values()))
        self.stats.puts += 1

    def _dispatch(self, key: str) -> torch.Tensor:
        """One-to-all: the controller's global value, on this rank's device."""
        held = self._host_store[key]
        if self.mesh.torch_mesh is None:
            return held.to(self.mesh.device, copy=True)
        import torch.distributed as dist

        from repro_torch.distributed import collectives

        wire = collectives.transport(self.mesh)
        buf = (held.to(wire, copy=True) if self._controller()
               else torch.empty(held[0], dtype=held[1], device=wire))
        dist.broadcast(buf, src=0)
        return buf.to(self.mesh.device)

    def get(self, key: str, spec: Optional[Spec] = None) -> torch.Tensor:
        # one-to-all: the controller dispatches to the consumer
        full = self._dispatch(key)
        self.stats.bytes_through_controller += _nbytes(full)
        self.stats.redistributions += 1
        if spec is None or self.mesh.torch_mesh is None:
            return full
        from repro_torch.distributed import collectives

        return collectives.shard(self.mesh, full, _normalize(spec, full.ndim)).clone()

    def global_value(self, key: str) -> torch.Tensor:
        return self.get(key) if self.mesh.torch_mesh is None else self._dispatch(key)

    def keys(self):
        return list(self._host_store)

    def pop(self, key: str) -> torch.Tensor:
        out = self._dispatch(key)
        del self._host_store[key]
        return out

    def clear(self) -> None:
        super().clear()
        self._host_store.clear()
