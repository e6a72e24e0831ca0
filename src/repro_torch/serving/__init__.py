"""Request-streaming serving of the PyTorch port (port of ``repro.serving``;
see docs/serving.md): requests arrive whenever they arrive, stream token
deltas back as they decode, share prompt KV through a radix prefix cache
over a paged arena, and keep decoding across live weight hot-swaps.
"""
from repro_torch.serving.engine import ServingEngine, request_seed
from repro_torch.serving.paged_arena import ArenaOutOfPages, PagedKVArena
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.scheduler import (
    AdmissionQueue,
    Request,
    RequestStream,
    percentiles,
    synthetic_requests,
)

__all__ = [
    "ServingEngine",
    "ArenaOutOfPages",
    "PagedKVArena",
    "RadixPrefixCache",
    "AdmissionQueue",
    "Request",
    "RequestStream",
    "percentiles",
    "request_seed",
    "synthetic_requests",
]
