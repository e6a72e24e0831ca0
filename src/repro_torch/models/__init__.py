"""Models of the PyTorch port: the dense decoder-only LM."""
from repro_torch.models.api import Model, get_model

__all__ = ["Model", "get_model"]
