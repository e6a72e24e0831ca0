"""Weight bridge between the JAX package's param pytree and the port's params.

The JAX pytree (``repro.models.lm.init``) stacks each block parameter over
layer groups: ``params["blocks"]`` is a list with one dict per position of
the layer pattern, each leaf shaped ``(N, ...)``, and layer ``i`` is group
``i // P`` of position ``i % P``. The port keeps one dict of weights per
layer. Both sides keep the ``(d_in, d_out)`` layout, so leaves map one to
one, SSD leaves too (``A_log``, ``D``, ``dt_bias`` and ``norm_w`` are f32,
the projections and convolutions bf16).

Critic params (``repro.rl.critic.init``: ``{"backbone": lm params without
a token head, "v_head": (d, 1) f32}``) cross the same way, the backbone as
an LM's. Encoder-decoder params (``repro.models.encdec.init``) stack each
of their two stacks, ``"encoder"`` and ``"decoder"``, over its layers,
``(L, ...)``; the port keeps a list of per-layer dicts for each. Norm
biases and linear biases are leaves like any other.

Arrays cross as numpy (the caller turns JAX arrays into numpy arrays first).
bf16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses,
so it crosses as its 16-bit pattern and is viewed back on the other side:
the round trip is bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models.lm import smallest_period

STACKS = ("encoder", "decoder")  # an encoder-decoder's per-layer stacks


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


def from_jax(jax_params: Dict[str, Any], *, device,
             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX param pytree (numpy leaves) -> the port's params on ``device``
    (required: there is no default device). ``dtype`` casts every float leaf
    (``torch.float32`` for the fp32 parity tests). Critic and
    encoder-decoder params too."""
    conv = lambda a: _to_tensor(a, device, dtype)  # noqa: E731
    if "backbone" in jax_params:
        return {"backbone": from_jax(jax_params["backbone"], device=device, dtype=dtype),
                "v_head": conv(jax_params["v_head"])}
    if "encoder" in jax_params:
        out = {k: tree.map(conv, v) for k, v in jax_params.items() if k not in STACKS}
        for k in STACKS:
            n = len(np.asarray(jax_params[k]["norm1"]["w"]))
            out[k] = [tree.map(lambda a, i=i: conv(np.asarray(a)[i]), jax_params[k])
                      for i in range(n)]
        return out
    groups = jax_params["blocks"]  # one stacked dict per pattern position
    P = len(groups)
    N = len(np.asarray(groups[0]["norm1"]["w"]))
    blocks = [tree.map(lambda a, g=i // P: conv(np.asarray(a)[g]), groups[i % P])
              for i in range(N * P)]
    out = {k: tree.map(conv, v) for k, v in jax_params.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def _layer_kind(block: Dict[str, Any]):
    """(mixer kind, MLP kind) of one layer's weights, as
    ``ModelConfig.layer_kinds`` names them."""
    mixer = "attn" if "attn" in block else "ssm"
    mlp = "dense" if "mlp" in block else ("moe" if "moe" in block else "none")
    return mixer, mlp


def to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params -> the JAX param pytree with numpy leaves: the
    layers stacked by the layer pattern (``lm.pattern_length``), position
    ``p`` of the pattern holding layers p, p + P, p + 2P, ... (a hybrid's
    attention and SSD layers land in their own positions). Critic and
    encoder-decoder params too."""
    if "backbone" in params:
        return {"backbone": to_jax(params["backbone"]), "v_head": _to_numpy(params["v_head"])}
    if "encoder" in params:
        out = {k: tree.map(_to_numpy, v) for k, v in params.items() if k not in STACKS}
        out.update({k: _stack(params[k]) for k in STACKS})
        return out
    blocks = params["blocks"]
    P = smallest_period([_layer_kind(b) for b in blocks])
    out = {k: tree.map(_to_numpy, v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [_stack(blocks[pos::P]) for pos in range(P)]
    return out


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return np.stack([_to_numpy(t) for t in layers])
