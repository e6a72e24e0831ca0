"""Optimizers of the PyTorch port."""
from repro_torch.optim.adamw import (
    AdamWState,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    init,
    update,
)

__all__ = ["AdamWState", "clip_by_global_norm", "cosine_schedule", "global_norm",
           "init", "update"]
