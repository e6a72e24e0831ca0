"""Multi-host fleet runtime, coordinator plane and DP gradient exchange: the
port of ``repro.distributed.fleet``.

DistFlow's multi-controller scale-out (paper §5): every host runs the
identical program, and what differs per process is its ``process_id``:
which gradient slices it owns on the wire, where its heartbeats go, which
artifacts it writes. A port host is one process on one device
(``launch.mesh.make_fleet_mesh``: axes ``("pod", "data", "model")`` of
shape ``(num_hosts, 1, 1)``), and it computes the whole global batch, as a
host of the JAX package's simulated fleet does. The exchange rebuilds the
gradient from the slices each host owns (it does not sum them), so with
``grad_compression="none"`` a fleet is bit for bit a single-host run.

The pieces:

* :class:`FleetContext`: membership and failure detection over a shared
  coordinator directory (the "file plane"): atomic tmp+rename heartbeat
  files feed a :class:`repro_torch.ft.straggler.HeartbeatMonitor`; a
  blocked survivor detects a killed peer by wall-clock staleness, raises
  :class:`HostsLost`, and membership transitions are serialized through
  first-writer-wins epoch files so every survivor adopts the same view.
* :class:`GradExchange`: the DP gradient exchange in reduce-scatter /
  all-gather shape: the flat fp32 gradient vector is cut into ``num_hosts``
  contiguous slices; each live host publishes the slices it owns
  (ownership from :func:`repro_torch.ft.straggler.rebalance`, so a dead
  host's slices are re-assigned deterministically) and every peer rebuilds
  the vector from the published slices. ``"none"`` ships raw fp32;
  ``"int8_ef"`` ships the :mod:`repro_torch.distributed.compression` wire
  form with an error-feedback accumulator a slice. The vector is flattened
  (and encoded) on the gradient's device; only the wire payload crosses to
  the host.
* :func:`fleet_actor_step`: grad fn, exchange and apply fn composed into
  the worker's ``actor_step`` engine contract (bit for bit the fused
  ``trainer.make_actor_step``).

The files are the JAX package's: the same directory layout, json records and
npz keys, and the gradient flattened in JAX's leaf order (dict keys sorted),
so a JAX host and a port host can share one coordinator directory. Exchange
payloads live under ``<coordinator>/xchg/s<step>.e<epoch>/``; the epoch in
the path keeps post-recovery traffic apart from a dead epoch's files.
Payload files are never deleted mid-run (readers may lag); the coordinator
directory is ephemeral per run.
"""
from __future__ import annotations

import io
import json
import math
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import DistributedConfig
from repro_torch.distributed import compression
from repro_torch.ft import straggler
from repro_torch.obs.trace import get_tracer


class HostsLost(RuntimeError):
    """Raised out of a blocked exchange/barrier when peers are declared dead.

    The driver should ``declare_dead(exc.hosts)``, restore from the last
    checkpoint, rebuild its engines, and resume."""

    def __init__(self, hosts: Sequence[int]):
        self.hosts = sorted(hosts)
        super().__init__(f"hosts lost: {self.hosts}")


def _atomic_write(path: str, data: bytes) -> None:
    """Write-then-rename so readers never observe a partial file."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None  # missing, or a reader raced a (non-atomic) writer


class FleetContext:
    """Per-process view of the fleet: membership, heartbeats, file waits."""

    def __init__(self, cfg: DistributedConfig):
        if not cfg.enabled:
            raise ValueError("FleetContext needs num_hosts > 1")
        self.cfg = cfg
        self.root = cfg.coordinator
        self.num_hosts = cfg.num_hosts
        self.process_id = cfg.process_id
        self.members: List[int] = list(range(cfg.num_hosts))
        self.epoch = 0
        self.iteration = 0
        self.monitor = straggler.HeartbeatMonitor(
            cfg.num_hosts, patience=cfg.heartbeat_patience
        )
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop: Optional[threading.Event] = None
        os.makedirs(os.path.join(self.root, "hosts"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "membership"), exist_ok=True)
        self.sync_membership()  # adopt transitions from before we (re)started

    # -------------------------------------------------------------- #
    # heartbeats
    # -------------------------------------------------------------- #
    def _hb_path(self, host: int) -> str:
        return os.path.join(self.root, "hosts", f"host{host}.json")

    def heartbeat(self, iteration: Optional[int] = None) -> None:
        """Publish liveness. Call at least once per training iteration."""
        if iteration is not None:
            self.iteration = iteration
        payload = {"iteration": self.iteration, "time": time.time(),
                   "pid": os.getpid()}
        _atomic_write(self._hb_path(self.process_id),
                      json.dumps(payload).encode())
        self.monitor.beat(self.process_id, self.iteration, now=payload["time"])

    def start_heartbeats(self, interval: float = 0.5) -> None:
        """Background daemon thread beating every ``interval`` seconds:
        liveness keeps publishing while the main thread is inside a long
        first iteration, and stops the instant the process is killed (which
        is exactly the wall-clock staleness signal survivors key off)."""
        if self._hb_thread is not None:
            return
        self._hb_stop = threading.Event()

        def loop():
            while not self._hb_stop.wait(interval):
                try:
                    self.heartbeat()
                except OSError:
                    pass  # coordinator dir going away at shutdown

        self._hb_thread = threading.Thread(
            target=loop, daemon=True, name="fleet-heartbeat"
        )
        self._hb_thread.start()

    # -------------------------------------------------------------- #
    # observability snapshots (repro_torch.obs.aggregate)
    # -------------------------------------------------------------- #
    def publish_metrics(self, iteration: int, metrics: Dict) -> str:
        """Ship one iteration's metrics snapshot over the file plane for
        fleet-wide aggregation (``obs/aggregate.collect_snapshots`` /
        ``launch/obs_report.py``). Same atomic-write discipline as
        heartbeats; returns the snapshot path."""
        path = os.path.join(self.root, "obs", f"host{self.process_id}",
                            f"it{int(iteration):06d}.json")
        payload = {
            "host": self.process_id,
            "iteration": int(iteration),
            "time": time.time(),
            "metrics": {k: float(v) for k, v in metrics.items()},
        }
        _atomic_write(path, json.dumps(payload).encode())
        return path

    def stop_heartbeats(self) -> None:
        if self._hb_thread is not None:
            self._hb_stop.set()
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
            self._hb_stop = None

    def poll_peers(self) -> List[int]:
        """Feed peer heartbeats to the monitor; return members now considered
        dead (never excluding self). Wall-clock staleness is what lets a host
        *blocked* at the exchange (its own iteration frozen) still notice."""
        for h in self.members:
            hb = _read_json(self._hb_path(h))
            if hb is not None:
                self.monitor.beat(h, int(hb["iteration"]), now=float(hb["time"]))
        dead = self.monitor.dead(
            self.iteration, now=time.time(), stale_s=self.cfg.dead_after_s
        )
        return [h for h in dead if h in self.members and h != self.process_id]

    # -------------------------------------------------------------- #
    # membership epochs (first-writer-wins, so survivors agree)
    # -------------------------------------------------------------- #
    def _epoch_path(self, epoch: int) -> str:
        return os.path.join(self.root, "membership", f"epoch{epoch}.json")

    def sync_membership(self) -> bool:
        """Adopt any membership transition another survivor already
        published. Returns True if the epoch advanced."""
        advanced = False
        while True:
            rec = _read_json(self._epoch_path(self.epoch + 1))
            if rec is None:
                return advanced
            self.epoch += 1
            self.members = list(rec["members"])
            advanced = True

    def declare_dead(self, hosts: Sequence[int]) -> None:
        """Publish (or adopt) the next membership epoch without ``hosts``."""
        self.sync_membership()
        targets = [h for h in hosts if h in self.members]
        if not targets:
            return
        members = [m for m in self.members if m not in set(targets)]
        if self.process_id not in members:
            raise RuntimeError("cannot declare self dead")
        path = self._epoch_path(self.epoch + 1)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                json.dump({"members": members, "dead": sorted(targets)}, f)
        except FileExistsError:
            pass  # another survivor won the race; adopt its record
        self.sync_membership()

    @property
    def dead_hosts(self) -> List[int]:
        return [h for h in range(self.num_hosts) if h not in self.members]

    def partition(self) -> Dict[int, List[int]]:
        """Current shard-ownership map (host -> slice/shard ids): every
        member computes the identical map from the identical membership."""
        return straggler.rebalance([1.0] * self.num_hosts, dead=self.dead_hosts)

    def slice_owner(self) -> Dict[int, int]:
        return {s: h for h, shards in self.partition().items() for s in shards}

    # -------------------------------------------------------------- #
    # file waits + barrier
    # -------------------------------------------------------------- #
    def wait_files(self, paths: Sequence[str], *,
                   timeout: Optional[float] = None, poll: float = 0.05,
                   detect: bool = True) -> None:
        """Block until every path exists. While blocked (``detect=True``):
        keep our own heartbeat fresh, watch peers, adopt membership epochs
        other survivors publish, and raise :class:`HostsLost` the moment a
        peer whose file we may be waiting on is declared dead. ``detect=
        False`` is the bootstrap mode (startup barrier): peers that have not
        launched yet must not be mistaken for dead ones."""
        timeout = self.cfg.exchange_timeout_s if timeout is None else timeout
        deadline = time.monotonic() + timeout
        last_beat = 0.0
        while True:
            if all(os.path.exists(p) for p in paths):
                return
            now = time.monotonic()
            if now - last_beat > 0.5:
                self.heartbeat()
                last_beat = now
            if detect:
                before = set(self.members)
                if self.sync_membership():
                    raise HostsLost(before - set(self.members))
                lost = self.poll_peers()
                if lost:
                    raise HostsLost(lost)
            if now > deadline:
                missing = [p for p in paths if not os.path.exists(p)]
                raise TimeoutError(f"fleet wait timed out; missing {missing}")
            time.sleep(poll)

    def barrier(self, name: str, *, timeout: Optional[float] = None) -> None:
        """All current members rendezvous. No failure detection: used at
        bootstrap, where a slow-to-launch peer is not a dead peer."""
        d = os.path.join(self.root, "barrier", f"{name}.e{self.epoch}")
        _atomic_write(os.path.join(d, f"host{self.process_id}"), b"")
        self.wait_files([os.path.join(d, f"host{h}") for h in self.members],
                        timeout=timeout, detect=False)


# ------------------------------------------------------------------ #
# module-global context (set by launch.mesh.init_distributed)
# ------------------------------------------------------------------ #
_CONTEXT: Optional[FleetContext] = None


def set_context(ctx: Optional[FleetContext]) -> None:
    global _CONTEXT
    _CONTEXT = ctx


def get_context() -> Optional[FleetContext]:
    return _CONTEXT


def ensure_context(cfg: DistributedConfig) -> FleetContext:
    """The registered context if it matches ``cfg``, else a fresh one.
    Reuse is what preserves membership epochs across a post-recovery
    pipeline rebuild."""
    ctx = get_context()
    if (ctx is not None and ctx.root == cfg.coordinator
            and ctx.num_hosts == cfg.num_hosts
            and ctx.process_id == cfg.process_id):
        return ctx
    ctx = FleetContext(cfg)
    set_context(ctx)
    return ctx


# ------------------------------------------------------------------ #
# host <-> device geometry
# ------------------------------------------------------------------ #
def host_device_groups(mesh) -> List[List[int]]:
    """Device ids per host of a ``DeviceMesh``, numbered row-major over its
    axes as a JAX mesh numbers them. A ``pod`` axis defines the host
    grouping (one contiguous block of ids a host; a port fleet host has one
    device); a mesh without one is one host."""
    shape = mesh.shape
    n = math.prod(shape.values())
    hosts = shape.get("pod", 1)
    per = n // hosts
    return [list(range(h * per, (h + 1) * per)) for h in range(hosts)]


# ------------------------------------------------------------------ #
# gradient exchange
# ------------------------------------------------------------------ #
class GradExchange:
    """File-plane DP gradient exchange (reduce-scatter/all-gather shape).

    ``__call__`` takes the grad fn's gradient tree, publishes this host's
    owned contiguous slices of the flattened fp32 vector, waits for every
    slice, and returns the rebuilt tree (each leaf in its own dtype, on its
    own device) + wire metrics. Slice boundaries are fixed by the ORIGINAL
    ``num_hosts`` so they never move when membership shrinks; only
    ownership does (``FleetContext.partition``). ``wire_bytes`` counts
    published payload bytes per round (one copy per slice), the
    apples-to-apples number between the exact and compressed arms;
    ``wire_saved_bytes`` is the fp32 baseline minus that.

    The vector is built on the gradient's device, an owned slice is encoded
    there, and only its payload (the fp32 values, or the int8 blocks and
    scales) is copied to the host; a peer's payload is copied to the device
    and decoded there. An owned slice enters the rebuilt vector as its own
    decode, which is what a peer decodes from its file.
    """

    def __init__(self, fleet: FleetContext, mode: str = "none"):
        if mode not in ("none", "int8_ef"):
            raise ValueError(f"unknown grad_compression {mode!r}")
        self.fleet = fleet
        self.mode = mode
        self._step = -1
        self._errors: Dict[int, torch.Tensor] = {}  # slice id -> EF accumulator
        self.stats = {"exchanges": 0, "wire_bytes": 0, "exact_bytes": 0,
                      "wire_saved_bytes": 0}

    # ---------------- wire format ---------------- #
    def _slice_bounds(self, total: int) -> List[Tuple[int, int]]:
        H = self.fleet.num_hosts
        base, extra = divmod(total, H)
        bounds, lo = [], 0
        for i in range(H):
            hi = lo + base + (1 if i < extra else 0)
            bounds.append((lo, hi))
            lo = hi
        return bounds

    def _encode_slice(self, sid: int, seg: torch.Tensor) -> Tuple[bytes, torch.Tensor]:
        """(the npz payload of an owned slice, its decode on the device)."""
        buf = io.BytesIO()
        if self.mode == "none":
            np.savez(buf, v=seg.cpu().numpy())
            return buf.getvalue(), seg
        q, scale, err = compression.encode(seg, self._errors.get(sid))
        self._errors[sid] = err
        np.savez(buf, q=q.cpu().numpy(), s=scale.cpu().numpy(),
                 n=np.int64(seg.numel()))
        return buf.getvalue(), compression.decode(q, scale, (seg.numel(),), seg.numel())

    def _decode_slice(self, path: str, device: torch.device) -> torch.Tensor:
        with np.load(path) as z:
            if "v" in z:
                return torch.from_numpy(z["v"]).to(device)
            n = int(z["n"])
            q = torch.from_numpy(z["q"]).to(device)
            s = torch.from_numpy(z["s"]).to(device)
        return compression.decode(q, s, (n,), n)

    def _wire_bytes(self, seg: torch.Tensor) -> int:
        return compression.wire_bytes(seg)[0 if self.mode == "none" else 1]

    # ---------------- the exchange ---------------- #
    def __call__(self, grads) -> Tuple[Any, Dict[str, float]]:
        with get_tracer().span("fleet/grad_exchange", cat="fleet",
                               step=self._step + 1,
                               members=len(self.fleet.members),
                               compression=self.mode) as sp:
            out, metrics = self._exchange(grads)
            sp.set(wire_bytes=metrics["fleet/wire_bytes"])
            return out, metrics

    @torch.no_grad()
    def _exchange(self, grads) -> Tuple[Any, Dict[str, float]]:
        fleet = self.fleet
        self._step = max(self._step + 1, fleet.iteration)
        step = self._step
        # JAX's leaf order (dict keys sorted; None is an empty subtree), so a
        # slice id holds the same elements in both packages
        leaves, unflatten = tree.flatten(grads)
        order = [i for i in tree.jax_order(grads) if leaves[i] is not None]
        device = leaves[order[0]].device if order else torch.device("cpu")
        vector = torch.cat(
            [leaves[i].detach().reshape(-1).to(torch.float32) for i in order]
        ) if order else torch.zeros(0, dtype=torch.float32)
        bounds = self._slice_bounds(vector.numel())
        owner = fleet.slice_owner()

        xdir = os.path.join(fleet.root, "xchg", f"s{step}.e{fleet.epoch}")
        paths = [os.path.join(xdir, f"slice{sid}.npz") for sid in range(len(bounds))]
        published = 0
        for sid, (lo, hi) in enumerate(bounds):
            if owner[sid] != fleet.process_id:
                continue
            payload, own = self._encode_slice(sid, vector[lo:hi])
            _atomic_write(paths[sid], payload)
            vector[lo:hi] = own
            published += self._wire_bytes(vector[lo:hi])

        fleet.wait_files(paths)

        # the vector is rebuilt in place: every owned slice already holds its
        # decode, every other slice takes its owner's payload
        wire = exact = 0
        for sid, (lo, hi) in enumerate(bounds):
            if owner[sid] != fleet.process_id:
                vector[lo:hi] = self._decode_slice(paths[sid], device)
            wire += self._wire_bytes(vector[lo:hi])
            exact += (hi - lo) * 4

        self.stats["exchanges"] += 1
        self.stats["wire_bytes"] += wire
        self.stats["exact_bytes"] += exact
        self.stats["wire_saved_bytes"] += exact - wire
        metrics = {
            "fleet/wire_bytes": float(wire),
            "fleet/wire_saved_bytes": float(exact - wire),
            "fleet/published_bytes": float(published),
            "fleet/epoch": float(fleet.epoch),
            "fleet/members": float(len(fleet.members)),
        }
        new_leaves, pos = list(leaves), 0
        for i in order:
            size = leaves[i].numel()
            new_leaves[i] = vector[pos:pos + size].reshape(leaves[i].shape).to(leaves[i].dtype)
            pos += size
        return unflatten(new_leaves), metrics


def fleet_actor_step(grad_fn: Callable, apply_fn: Callable,
                     exchange: GradExchange) -> Callable:
    """Compose grad -> exchange -> apply into the worker's ``actor_step``
    engine contract. The split is bit for bit the fused
    ``trainer.make_actor_step``: the exchange sits exactly where a real
    deployment's DP all-reduce would."""

    def step(state, batch):
        grads, metrics = grad_fn(state.params, batch)
        grads, xmetrics = exchange(grads)
        state, apply_metrics = apply_fn(state, grads)
        return state, {**metrics, **apply_metrics, **xmetrics}

    return step
