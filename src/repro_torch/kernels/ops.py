"""Kernel dispatch of the PyTorch port (mirrors ``repro.kernels.ops``).

By default the tensor's device decides: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the kernel's plain PyTorch version. ``set_mode("ref")``
sends CUDA tensors to the plain versions as well; it is called explicitly, in
code, as the JAX package's ``ops.set_mode`` is (the kernel checks of
``chip_smoke.py`` and the tests do). There is no environment variable, and a
kernel that fails to build or launch raises: nothing falls back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention as _decode_attention
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.sampling import fused_sample as _fused_sample

_MODES = (None, "ref")
_MODE: Optional[str] = None


def set_mode(mode: Optional[str]) -> None:
    """``None``: dispatch by device (the default). ``"ref"``: plain versions
    on every device."""
    global _MODE
    if mode not in _MODES:
        raise ValueError(f"kernel mode must be one of {_MODES}, got {mode!r}")
    _MODE = mode


def current_mode() -> Optional[str]:
    return _MODE


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    if _MODE == "ref":
        return _ref.rmsnorm(x, w, eps=eps)
    return _rmsnorm(x, w, eps=eps)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None, q_offset=0):
    if _MODE == "ref":
        return _ref.flash_attention(q, k, v, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset)
    return _flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                            q_offset=q_offset)


def decode_attention(
    q, k, v, cache_len, *, scale=None, window=None, pos_offset=0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o, lse) in every mode."""
    if _MODE == "ref":
        return _ref.decode_attention(q, k, v, cache_len, scale=scale,
                                     window=window, pos_offset=pos_offset)
    return _decode_attention(q, k, v, cache_len, scale=scale, window=window,
                             pos_offset=pos_offset)


def fused_sample(
    h, w_head, seeds, inv_temp, *, vocab_size=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head product + hash Gumbel-max sampler: (token, untempered logprob).
    Unlike the JAX ``ops.fused_sample``, it takes the per-row int32 seeds and
    inverse temperatures directly (the kernel's own inputs), so both modes
    draw the same tokens from the same seeds."""
    if _MODE == "ref":
        return _ref.fused_sample(h, w_head, seeds, inv_temp, vocab_size=vocab_size)
    return _fused_sample(h, w_head, seeds, inv_temp, vocab_size=vocab_size)
