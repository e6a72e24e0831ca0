"""Metrics of the PyTorch port: a copy of ``repro.obs.metrics``."""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LATENCY_BOUNDARIES,
    MetricsRegistry,
    exponential_boundaries,
)
