"""Fleet bring-up: the port of ``repro.launch.mesh``'s multi-host half.

:func:`init_distributed` resolves the ``coordinator`` string. A filesystem
path is a shared DIRECTORY, the fleet's file plane: a
:class:`repro_torch.distributed.fleet.FleetContext` is built from a
validated ``DistributedConfig`` and registered as the process-global
context that ``build_pipeline`` picks up. A ``host:port`` address is the
JAX package's ``jax.distributed.initialize``, whose counterpart is
``torch.distributed``; it comes with the sharding layer.
:func:`make_fleet_mesh` builds the ``(pod, data, model)`` placement every
host agrees on: one row a host, one device a host.

The production and local meshes of several devices (``make_production_mesh``,
``make_local_mesh``) come with the sharding layer, ROADMAP queue 1, item 8.
"""
from __future__ import annotations

from repro_torch.core.databuffer import DeviceMesh


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item 8: distributed)")


def init_distributed(coordinator: str, num_processes: int = 1,
                     process_id: int = 0, **overrides):
    """Bring up the multi-host runtime; returns the registered
    :class:`repro_torch.distributed.fleet.FleetContext` (None when
    single-host), after its first heartbeat.

    ``overrides`` forward extra ``DistributedConfig`` fields (e.g.
    ``grad_compression``, ``dead_after_s``)."""
    if num_processes <= 1:
        return None
    from repro_torch.configs.base import DistributedConfig
    from repro_torch.distributed import fleet

    if ":" in coordinator and "/" not in coordinator:
        raise _not_ported(f"a host:port coordinator ({coordinator!r}, torch.distributed)")
    cfg = DistributedConfig(
        num_hosts=num_processes, process_id=process_id,
        coordinator=coordinator, **overrides,
    )
    ctx = fleet.ensure_context(cfg)
    ctx.heartbeat(0)
    return ctx


def make_fleet_mesh(num_hosts: int, devices_per_host: int = 0, *,
                    device="cuda") -> DeviceMesh:
    """The fleet placement ``("pod", "data", "model")`` of shape
    ``(num_hosts, 1, 1)`` on this host's ``device``. Every process calls it
    with identical arguments. A port host has one device
    (``devices_per_host`` 0 or 1)."""
    if devices_per_host > 1:
        raise _not_ported(f"a fleet host of {devices_per_host} devices")
    return DeviceMesh(device, {"pod": num_hosts, "data": 1, "model": 1})
