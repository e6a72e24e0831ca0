"""Weight bridge between the JAX package's param pytree and the port's params.

The JAX pytree (``repro.models.lm.init``) stacks each block parameter over
layer groups: ``params["blocks"]`` is a list with one dict per position of
the layer pattern, each leaf shaped ``(N, ...)``, and layer ``i`` is group
``i // P`` of position ``i % P``. The port keeps one dict of weights per
layer. Both sides keep the ``(d_in, d_out)`` layout, so leaves map one to
one.

Arrays cross as numpy (the caller turns JAX arrays into numpy arrays first).
bf16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses,
so it crosses as its 16-bit pattern and is viewed back on the other side:
the round trip is bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable: torch shares its memory
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax(jax_params: Dict[str, Any], *, device="cpu",
             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX param pytree (numpy leaves) -> the port's params. ``dtype`` casts
    every float leaf (``torch.float32`` for the fp32 parity tests)."""
    conv = lambda a: _to_tensor(a, device, dtype)  # noqa: E731
    groups = jax_params["blocks"]  # one stacked dict per pattern position
    P = len(groups)
    N = len(np.asarray(groups[0]["norm1"]["w"]))
    blocks = [_map(groups[i % P], lambda a, g=i // P: conv(np.asarray(a)[g]))
              for i in range(N * P)]
    out = {k: _map(v, conv) for k, v in jax_params.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params -> the JAX param pytree with numpy leaves: every
    layer stacked into one pattern position, as the dense family has."""
    out = {k: _map(v, _to_numpy) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [_stack(params["blocks"])]
    return out


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return np.stack([_to_numpy(t) for t in layers])
