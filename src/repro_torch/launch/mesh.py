"""Production meshes and multi-process bring-up: the port of
``repro.launch.mesh``.

Defined as functions, so importing this module starts no process group.

- :func:`make_production_mesh`: the shape-only ``(16, 16)`` ``(data,
  model)`` mesh of one pod, or ``(2, 16, 16)`` ``(pod, data, model)`` of
  two, that the sharding rules (``distributed.sharding``) read.
- :func:`init_distributed` resolves the ``coordinator`` string. A
  ``host:port`` address starts ``torch.distributed``, one process a rank,
  the counterpart of ``jax.distributed.initialize``. Anything else is a
  shared DIRECTORY, the file plane of a data-parallel fleet: a
  :class:`repro_torch.distributed.fleet.FleetContext` is registered as the
  process-global context that ``build_pipeline`` picks up.
- :func:`make_fleet_mesh` builds the ``(pod, data, model)`` mesh every
  process agrees on: over a ``torch.distributed`` world, ``(H, D, 1)`` of
  H x D ranks, one device a rank; without one, a file-plane host's
  ``(H, 1, 1)`` placement of its one device. :func:`make_local_mesh` gives
  the world's ``(ranks, 1)`` mesh, or one device's.

The backend is chosen up front from the device: gloo on the CPU and where
the ranks of a host share a card (NCCL refuses two ranks on one device),
NCCL where each rank has a card of its own.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.core.databuffer import DeviceMesh


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item 8: distributed)")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The shape-only production mesh: (16, 16) over (data, model) for one
    pod, (2, 16, 16) over (pod, data, model) for two."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh(None, dict(zip(axes, shape)))


def backend_for(device, world_size: int) -> str:
    """gloo on the CPU and where the ranks share a card; nccl where every
    rank of this host has a card of its own."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def _rank_mesh(device, shape: Dict[str, int]) -> DeviceMesh:
    """The rank mesh of ``shape`` over the running world, one rank a device,
    row-major over the axes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if math.prod(shape.values()) != world:
        raise ValueError(f"a mesh of {math.prod(shape.values())} ranks over a world of {world}")
    wire = "cpu" if dist.get_backend() == "gloo" else "cuda"
    tmesh = init_device_mesh(wire, tuple(shape.values()), mesh_dim_names=tuple(shape))
    return DeviceMesh(device, shape, torch_mesh=tmesh)


def world_size() -> int:
    """Ranks of the running ``torch.distributed`` world (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_local_mesh(shape=None, axes=("data", "model"), *, device="cuda") -> DeviceMesh:
    """Whatever the running world offers: ``(ranks, 1)`` over the world's
    ranks, or one device's ``(1, 1)`` without a world."""
    n = world_size()
    if shape is None:
        shape = (n, 1) if len(axes) == 2 else (n,)
    shape = dict(zip(axes, shape))
    if n == 1:
        if math.prod(shape.values()) > 1:
            raise ValueError(
                f"a mesh of {math.prod(shape.values())} ranks needs a torch.distributed world "
                "of as many (launch.mesh.init_distributed with a host:port coordinator)")
        return DeviceMesh(device, shape)
    return _rank_mesh(device, shape)


def is_rank_coordinator(coordinator: str) -> bool:
    """Whether ``coordinator`` is a ``host:port`` address (a
    ``torch.distributed`` world of ranks), not a fleet's shared directory."""
    return ":" in coordinator and "/" not in coordinator


def init_distributed(coordinator: str, num_processes: int = 1, process_id: int = 0, *,
                     device="cuda", **overrides):
    """Bring up the multi-process runtime. Returns the registered
    :class:`repro_torch.distributed.fleet.FleetContext` of a file-plane
    fleet, after its first heartbeat, or None: single-process, or a
    ``host:port`` coordinator, which starts a ``torch.distributed`` world of
    ``num_processes`` ranks (this one ``process_id``) with the backend
    :func:`backend_for` picks. Under NCCL each rank takes the card of its
    index on its host.

    ``overrides`` forward extra ``DistributedConfig`` fields of the file
    plane (e.g. ``grad_compression``, ``dead_after_s``)."""
    if num_processes <= 1:
        return None
    if is_rank_coordinator(coordinator):
        import torch.distributed as dist

        if not dist.is_initialized():
            backend = backend_for(device, num_processes)
            if backend == "nccl":
                torch.cuda.set_device(process_id % torch.cuda.device_count())
            dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                    world_size=num_processes, rank=process_id)
        return None
    from repro_torch.configs.base import DistributedConfig
    from repro_torch.distributed import fleet

    if overrides.get("devices_per_host", 0) > 1:  # before any file of the fleet is written
        raise _not_ported(f"a file-plane fleet host of {overrides['devices_per_host']} devices")
    cfg = DistributedConfig(num_hosts=num_processes, process_id=process_id,
                            coordinator=coordinator, **overrides)
    ctx = fleet.ensure_context(cfg)
    ctx.heartbeat(0)
    return ctx


def fleet_mesh_shape(devices: int, num_hosts: int, devices_per_host: int = 0,
                     *, model_parallel: int = 1) -> Dict[str, int]:
    """The ``(pod, data, model)`` shape of a fleet of ``num_hosts`` hosts
    over ``devices`` devices (0 a host: as many as divide evenly), with the
    JAX package's refusals."""
    if devices_per_host == 0:
        if devices % num_hosts:
            raise ValueError(f"{devices} devices not divisible by {num_hosts} hosts")
        devices_per_host = devices // num_hosts
    need = num_hosts * devices_per_host
    if need > devices:
        raise ValueError(f"fleet needs {need} devices, the world offers {devices} "
                         f"(start {need} ranks)")
    if devices_per_host % model_parallel:
        raise ValueError(f"devices_per_host {devices_per_host} not divisible by "
                         f"model_parallel {model_parallel}")
    return {"pod": num_hosts, "data": devices_per_host // model_parallel,
            "model": model_parallel}


def make_fleet_mesh(num_hosts: int, devices_per_host: int = 0, *, model_parallel: int = 1,
                    device="cuda") -> DeviceMesh:
    """The fleet's ``(pod, data, model)`` mesh; every process calls it with
    identical arguments. Over a ``torch.distributed`` world: ``(H, D,
    model_parallel)`` over the world's ranks, one device a rank. Without
    one (the file plane): ``(num_hosts, 1, 1)`` on this host's ``device``,
    a port host having one device."""
    n = world_size()
    if n > 1:
        shape = fleet_mesh_shape(n, num_hosts, devices_per_host, model_parallel=model_parallel)
        if math.prod(shape.values()) != n:
            raise ValueError(f"a fleet of {math.prod(shape.values())} ranks in a world of {n}")
        return _rank_mesh(device, shape)
    if devices_per_host > 1 or model_parallel > 1:
        raise _not_ported(f"a file-plane fleet host of {max(devices_per_host, model_parallel)} "
                          "devices")
    return DeviceMesh(device, {"pod": num_hosts, "data": 1, "model": 1})


def mesh_of(shape: Tuple[int, ...], axes: Tuple[str, ...], *, device="cuda") -> DeviceMesh:
    """``ExperimentSpec.mesh_shape`` over ``mesh_axes``: one device's mesh
    for a shape of one device, else a rank mesh over the running world."""
    if math.prod(shape) <= 1:
        return DeviceMesh(device, dict(zip(axes, shape)))
    return make_local_mesh(shape, axes, device=device)
