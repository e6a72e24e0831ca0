"""Kernel dispatch of the PyTorch port (mirrors ``repro.kernels.ops``).

By default the tensor's device decides: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the kernel's plain PyTorch version. ``set_mode("ref")``
sends CUDA tensors to the plain versions as well; it is called explicitly, in
code, as the JAX package's ``ops.set_mode`` is (the kernel checks of
``chip_smoke.py`` and the tests do). There is no environment variable, and a
kernel that fails to build or launch raises: nothing falls back.

Under grad mode, with an input that requires grad, ``rmsnorm``,
``flash_attention`` and ``ssd`` go through their autograd Functions (the
kernel forward, the plain version's VJP backward); the other kernels have no
backward and raise on a CUDA tensor there. In ``ref`` mode autograd
differentiates the plain versions directly, as ``jax.grad`` does in the JAX
package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels.decode_attention import decode_attention as _decode_attention
from repro_torch.kernels.decode_attention_quant import (
    decode_attention_quant as _decode_attention_quant,
)
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention as _paged_decode_attention,
)
from repro_torch.kernels.rmsnorm import RMSNormFn
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.sampling import fused_sample as _fused_sample
from repro_torch.kernels.ssd import SSDFn

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


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            width: Optional[int] = None) -> torch.Tensor:
    """RMSNorm over the last dim. ``width``: the whole width of rows whose
    columns are split over ``model`` (tensor parallelism), x (..., D) and w
    (D,) this rank's columns. Where it exceeds D the rows are normalised by
    their mean square over the whole width, in three steps: the sum of
    squares of this rank's columns (kernel), summed over ``model`` in both
    directions (``copy_to_model(reduce_from_model(.))``), then the forward
    from that sum (kernel)."""
    if width is not None and width != x.shape[-1]:
        return _rmsnorm_split(x, w, eps, width)
    if _MODE == "ref":
        return _ref.rmsnorm(x, w, eps=eps)
    if _build.wants_grad(x, w):
        return RMSNormFn.apply(x, w, eps)
    return _rmsnorm(x, w, eps=eps)


def _rmsnorm_split(x, w, eps: float, width: int) -> torch.Tensor:
    from repro_torch.distributed import constraint

    if _MODE == "ref":
        ss = _ref.rmsnorm_sumsq(x)
    elif _build.wants_grad(x):
        ss = _rn.RMSNormSumSqFn.apply(x)
    else:
        ss = _rn.rmsnorm_sumsq(x)
    ss = constraint.copy_to_model(constraint.reduce_from_model(ss))
    if _MODE == "ref":
        return _ref.rmsnorm_scaled(x, ss, w, width=width, eps=eps)
    if _build.wants_grad(x, ss, w):
        return _rn.RMSNormScaledFn.apply(x, ss, w, width, eps)
    return _rn.rmsnorm_scaled(x, ss, w, width=width, eps=eps)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None, q_offset=0):
    if _MODE == "ref":
        return _ref.flash_attention(q, k, v, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset)
    if _build.wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale, q_offset)
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


def decode_attention_quant(
    q, k, v, k_scale, v_scale, cache_len, *, scale=None, window=None, pos_offset=0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash decode over an int8 cache with per-slot, per-head f32 scales.
    The kernel dequantizes each tile as it loads it; the plain version
    dequantizes the whole cache to bf16 first (the JAX oracle). Returns
    (o, lse) in every mode."""
    if _MODE == "ref":
        return _ref.decode_attention_quant(q, k, v, k_scale, v_scale, cache_len, scale=scale,
                                           window=window, pos_offset=pos_offset)
    return _decode_attention_quant(q, k, v, k_scale, v_scale, cache_len, scale=scale,
                                   window=window, pos_offset=pos_offset)


def paged_decode_attention(
    q, pool_k, pool_v, tables, kv_len, *, scale=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash decode straight out of the paged KV pool through each row's
    block-table row. Returns (o, lse) in every mode."""
    if _MODE == "ref":
        return _ref.paged_decode_attention(q, pool_k, pool_v, tables, kv_len, scale=scale)
    return _paged_decode_attention(q, pool_k, pool_v, tables, kv_len, scale=scale)


def combine_decode_shards(o_parts, lse_parts, *, return_lse: bool = False):
    """Merge per-shard (o, lse) of disjoint key ranges: plain torch on every
    device, as in the JAX package (it has no Pallas kernel). With
    ``return_lse`` also the merged lse."""
    return _ref.combine_decode_shards(o_parts, lse_parts, return_lse=return_lse)


def fused_sample(
    h, w_head, seeds, inv_temp, *, vocab_size=None, top_p: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head product + hash Gumbel-max sampler: (token, untempered logprob).
    Unlike the JAX ``ops.fused_sample``, it takes the per-row int32 seeds and
    inverse temperatures directly (the kernel's own inputs), so both modes
    draw the same tokens from the same seeds. ``top_p < 1`` takes the plain
    sampler on every device, as the JAX dispatch does: the kernel's online
    sweep over the vocab cannot see the sorted distribution. That route is
    chosen by the argument; a kernel that fails still raises."""
    if _MODE == "ref" or top_p < 1.0:
        return _ref.fused_sample(h, w_head, seeds, inv_temp, vocab_size=vocab_size,
                                 top_p=top_p)
    return _fused_sample(h, w_head, seeds, inv_temp, vocab_size=vocab_size)


def sample_logits(z, seeds, inv_temp, *, vocab_size=None,
                  top_p: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampler's rule on the head's materialised fp32 logits (B, Vp): a
    tensor-parallel head's, gathered over ``model``, under ``top_p < 1``.
    Plain torch on every device, as :func:`fused_sample` takes it there."""
    return _ref.sample_logits(z, seeds, inv_temp, vocab_size=vocab_size, top_p=top_p)


def fused_sample_shard(mesh, h, w_head, seeds, inv_temp, *, vocab_size=None,
                       col_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampler over a head whose vocab columns are split over ``model``
    (tensor parallelism): ``w_head`` (d, Vp / M) is this rank's shard, which
    starts at global column ``col_offset``. The kernel (on ``ref`` mode or a
    CPU tensor, ``ref.sample_state``) gives this shard's merged online state;
    the ranks all-gather the states over ``model`` and merge them in rank
    order (``ref.merge_sample_states``). The tokens equal the one-device
    sampler's bit for bit; the logprob differs only by the order of the
    sums. No rank holds the whole head."""
    from repro_torch.distributed import collectives

    if _MODE == "ref":
        m, l, y, z, i = _ref.sample_state(h, w_head, seeds, inv_temp, vocab_size=vocab_size,
                                          col_offset=col_offset)
        floats, idx = torch.stack([m, l, y, z], dim=1), i
    else:
        floats, idx = _fused_sample(h, w_head, seeds, inv_temp, vocab_size=vocab_size,
                                    col_offset=col_offset, state=True)
    # one gather: fp32 values and int32 indices are exact in float64
    wire = torch.cat([floats.double(), idx.double()[:, None]], dim=1)[None]
    every = collectives.all_gather(mesh, wire, ("model",), axes=("model",))
    states = [tuple(part[:, k].float() for k in range(4)) + (part[:, 4].long(),)
              for part in every]
    return _ref.merge_sample_states(states)


def fused_sample_rows(h, w_head, seeds, temps, *, vocab_size=None) -> torch.Tensor:
    """Per-row-temperature sampler of the serving engine: rows with
    ``temps <= 0`` take the argmax, the others the hash Gumbel-max draw at
    ``1 / max(temps, 1e-6)``; the same ``fused_sample`` kernel. Returns the
    tokens only (serving keeps no behaviour logprobs). Takes int32 seeds
    where the JAX ``ops.fused_sample_rows`` takes PRNG keys."""
    if _MODE == "ref":
        return _ref.fused_sample_rows(h, w_head, seeds, temps, vocab_size=vocab_size)
    tok, _ = _fused_sample(h, w_head, seeds, _ref.row_inv_temp(temps), vocab_size=vocab_size)
    return tok


def ssd(x, dt, A, Bm, Cm, D, *, chunk: int = 128, return_state: bool = False):
    """Mamba2 chunked scan with ``chunk = min(chunk, S)``; ``S`` must be a
    multiple of it (ValueError), as in the JAX package. Returns y, or
    (y, final fp32 state) with ``return_state``."""
    if _MODE == "ref":
        y, h = _ssd.plain(x, dt, A, Bm, Cm, D, chunk=chunk)
    elif _build.wants_grad(x, dt, A, Bm, Cm, D):
        y, h = SSDFn.apply(x, dt, A, Bm, Cm, D, chunk)
    else:
        y, h = _ssd.ssd(x, dt, A, Bm, Cm, D, chunk=chunk)
    return (y, h) if return_state else y


def ssd_decode_step(x, dt, A, Bm, Cm, D, h):
    """One-token SSD step: plain torch on every device, as in the JAX
    package (it has no Pallas kernel: a few elementwise products)."""
    return _ref.ssd_decode_step(x, dt, A, Bm, Cm, D, h)
