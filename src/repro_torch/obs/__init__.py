"""Telemetry of the PyTorch port: span tracing, typed metrics, sinks and
fleet aggregation, copies of ``repro.obs`` (docs/observability.md describes
both)."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LATENCY_BOUNDARIES,
    MetricsRegistry,
    exponential_boundaries,
)
from repro_torch.obs.sinks import (  # noqa: F401
    JSONLSink,
    MemorySink,
    StdoutSink,
    iteration_record,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    Tracer,
    get_tracer,
    set_tracer,
)


@dataclasses.dataclass
class ObsState:
    """The per-pipeline observability runtime build_pipeline hangs on
    ``ctx.obs`` when ObsConfig is enabled: the config, the (installed)
    tracer, and the registry absorbing each iteration's metrics."""

    cfg: Any
    tracer: Tracer
    registry: MetricsRegistry


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JSONLSink",
    "LATENCY_BOUNDARIES",
    "MemorySink",
    "MetricsRegistry",
    "NULL_TRACER",
    "ObsState",
    "StdoutSink",
    "Tracer",
    "exponential_boundaries",
    "get_tracer",
    "iteration_record",
    "set_tracer",
]
