"""RMSNorm: ``csrc/rmsnorm.cu`` on a CUDA tensor, the plain version on a CPU
tensor. Port of ``repro.kernels.rmsnorm``.

x (..., D) bf16 with w (D,) fp32 and the gemma-style ``(1 + w)`` scale.

:class:`RMSNormFn` is the autograd Function that ``ops.rmsnorm`` takes when a
gradient is wanted: its forward is :func:`rmsnorm` (the kernel on a CUDA
tensor), its backward the VJP of the plain version, recomputed from the
saved inputs. The JAX package has no ``custom_vjp``: ``jax.grad``
differentiates the same plain version, so this is its gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as plain
from repro_torch.kernels.ref import vjp

_c = ctypes


@functools.lru_cache(maxsize=None)
def _fwd():
    return _build.entry("rmsnorm", "rmsnorm_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_float,
        _c.c_int, _c.c_void_p])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain(x, w, eps=eps)
    _build.require(x.device.type == "cuda", f"no rmsnorm kernel for {x.device}")
    _build.require_no_grad("rmsnorm", x, w)
    _build.require_cuda(x, w)
    _build.require(x.dtype == torch.bfloat16 and w.dtype == torch.float32,
                   f"rmsnorm kernel takes bf16 x and fp32 w, got {x.dtype}, {w.dtype}")
    D = x.shape[-1]
    _build.require(D % 2 == 0 and w.shape == (D,), f"rmsnorm: D={D}, w {tuple(w.shape)}")
    out = torch.empty_like(x)
    device, stream = _build.launch_site(x)
    fn = _fwd()
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // D, D, eps,
             device, stream)
    _build.check(_build.library("rmsnorm"), err, "rmsnorm")
    _build.LAUNCHES["rmsnorm"] += 1
    return out


class RMSNormFn(torch.autograd.Function):
    """Forward through :func:`rmsnorm`, backward by the plain version's VJP."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, gy):
        dx, dw = vjp(plain, ctx.saved_tensors, gy, ctx.needs_input_grad[:2], eps=ctx.eps)
        return dx, dw, None
