"""Gradient compression for the data-parallel exchange: the port of
``repro.distributed.compression``.

Per-block int8 quantization with one fp32 scale a block of ``BLOCK``
elements: wire bytes drop to about 1/4 of fp32 at the price of quantization
noise, and an error-feedback accumulator (``ef_update``, the ``error``
argument of ``encode``) carries the residual into the next round, which
keeps the bias bounded.

``encode``/``decode`` are the wire form of the fleet's gradient exchange
(``repro_torch.distributed.fleet.GradExchange``): each host publishes the
int8 blocks and fp32 scales of the gradient slice it owns, and every peer
decodes them. They run on the tensor's own device; the arithmetic (a
half-to-even ``round`` of correctly rounded fp32 divisions, one fp32
product to decode) is the same on the CPU and the card, so the bits equal
the JAX package's. ``wire_bytes`` is the byte accounting: the padded int8 block
payload plus one fp32 scale a block.

``compressed_psum`` is the in-mesh form over a rank mesh's axis: each rank
quantizes its value, the int8 blocks and scales are all-gathered over the
axis, and every rank decodes and sums them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

BLOCK = 256  # quantization block (one scale a block)
# the least divisor a block is quantized against: a block whose max |x| is
# under 127 * SCALE_FLOOR decodes to values of its sign that may be far from
# it (its error stays under its max, and error feedback carries it)
SCALE_FLOOR = 1e-12


def num_blocks(size: int) -> int:
    """Quantization blocks covering ``size`` elements (>= 1: the empty
    tensor still ships one scale so the wire format is self-describing)."""
    return max((size + BLOCK - 1) // BLOCK, 1)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 (blocks, BLOCK), scale fp32 (blocks, 1))."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK).to(torch.float32)
    # divided by a tensor on the device: CUDA turns a division by a Python
    # scalar into a product with its reciprocal, which rounds differently
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.tensor(127.0, device=blocks.device)
    q = torch.round(blocks / torch.clamp(scale, min=SCALE_FLOOR)).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, size: int) -> torch.Tensor:
    out = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return out.reshape(shape)


def compressed_psum(mesh, x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (a name or a tuple of names)
    of a rank mesh, with an int8 all-gather of the blocks and scales and a
    local decode and sum, in ``x``'s dtype."""
    from repro_torch.distributed import collectives

    spec = (axis,)
    q, scale = _quantize(x)
    q_all = collectives.all_gather(mesh, q[None], spec)  # (n, blocks, BLOCK) int8
    s_all = collectives.all_gather(mesh, scale[None], spec)
    total = torch.sum(q_all.to(torch.float32) * s_all, dim=0)
    return total.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)


def ef_update(grad: torch.Tensor, error: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error feedback: compress (grad + carried error); carry the residual."""
    target = grad.to(torch.float32) + error
    q, scale = _quantize(target)
    decoded = _dequantize(q, scale, grad.shape, grad.numel())
    return decoded.to(grad.dtype), target - decoded


def encode(x: torch.Tensor, error: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wire form of one gradient slice: ``(q, scale, new_error)``.

    With ``error`` (the error-feedback accumulator, fp32, same shape) the
    residual of the previous rounds is folded in before quantizing and the
    new residual is returned; ``error=None`` encodes memorylessly."""
    target = x.to(torch.float32)
    if error is not None:
        target = target + error
    q, scale = _quantize(target)
    new_error = target - _dequantize(q, scale, target.shape, target.numel())
    return q, scale, new_error


def decode(q: torch.Tensor, scale: torch.Tensor, shape, size: int) -> torch.Tensor:
    """Inverse of :func:`encode` (up to quantization error)."""
    return _dequantize(q, scale, shape, size)


def wire_bytes(x: torch.Tensor) -> Tuple[int, int]:
    """(exact bytes, compressed bytes) for one exchange of ``x``: the raw
    payload at the tensor's own dtype width, and ``num_blocks * BLOCK``
    padded int8 lanes plus one fp32 scale a block."""
    exact = x.numel() * x.element_size()
    nb = num_blocks(x.numel())
    return exact, nb * BLOCK + nb * 4
