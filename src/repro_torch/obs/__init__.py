"""Telemetry of the PyTorch port: copies of ``repro.obs.metrics`` and
``repro.obs.trace``."""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LATENCY_BOUNDARIES,
    MetricsRegistry,
    exponential_boundaries,
)
from repro_torch.obs.trace import Tracer, get_tracer, set_tracer  # noqa: F401
