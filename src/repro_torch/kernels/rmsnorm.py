"""RMSNorm: ``csrc/rmsnorm.cu`` on a CUDA tensor, the plain version on a CPU
tensor. Port of ``repro.kernels.rmsnorm``.

x (..., D) bf16 with w (D,) fp32 and the gemma-style ``(1 + w)`` scale.

:class:`RMSNormFn` is the autograd Function that ``ops.rmsnorm`` takes when a
gradient is wanted: its forward is :func:`rmsnorm` (the kernel on a CUDA
tensor), its backward the VJP of the plain version, recomputed from the
saved inputs. The JAX package has no ``custom_vjp``: ``jax.grad``
differentiates the same plain version, so this is its gradient.

A row whose width is split over ranks (tensor parallelism) takes two more
entries of ``csrc/rmsnorm.cu``: :func:`rmsnorm_sumsq`, the rows' fp32 sums of
``x^2`` over this rank's columns (counted as ``rmsnorm_sumsq``), and, once the
caller has summed them over the ranks, :func:`rmsnorm_scaled`, the forward
from those sums and the whole width (counted as ``rmsnorm_scaled``). :class:`RMSNormSumSqFn` and :class:`RMSNormScaledFn`
are their autograd Functions, each with its plain version's VJP as backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as plain
from repro_torch.kernels.ref import rmsnorm_scaled as plain_scaled
from repro_torch.kernels.ref import rmsnorm_sumsq as plain_sumsq
from repro_torch.kernels.ref import vjp

_c = ctypes


@functools.lru_cache(maxsize=None)
def _fwd():
    return _build.entry("rmsnorm", "rmsnorm_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_float,
        _c.c_int, _c.c_void_p])


@functools.lru_cache(maxsize=None)
def _sumsq():
    return _build.entry("rmsnorm", "rmsnorm_sumsq", [
        _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p])


@functools.lru_cache(maxsize=None)
def _scaled():
    return _build.entry("rmsnorm", "rmsnorm_scaled_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_int,
        _c.c_float, _c.c_int, _c.c_void_p])


def _require_rows(name: str, x: torch.Tensor, *more: torch.Tensor) -> int:
    """Check a kernel call's bf16 rows ``x`` (..., D), D even, and its fp32
    sums and weights ``more``: one CUDA device, contiguous, aligned, no
    gradient wanted. Returns D."""
    _build.require(x.device.type == "cuda", f"no {name} kernel for {x.device}")
    _build.require_no_grad(name, x, *more)
    _build.require_cuda(x, *more)
    _build.require(x.dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in more),
                   f"{name} kernel takes bf16 x and fp32 sums and weights, got {x.dtype}, "
                   f"{[t.dtype for t in more]}")
    D = x.shape[-1]
    _build.require(D % 2 == 0, f"{name}: D={D} is odd")
    return D


def rmsnorm_sumsq(x: torch.Tensor) -> torch.Tensor:
    """The rows' fp32 sums of ``x^2``: (...) for x (..., D)."""
    if x.device.type == "cpu":
        return plain_sumsq(x)
    D = _require_rows("rmsnorm_sumsq", x)
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    device, stream = _build.launch_site(x)
    err = _sumsq()(x.data_ptr(), out.data_ptr(), x.numel() // D, D, device, stream)
    _build.check(_build.library("rmsnorm"), err, "rmsnorm_sumsq")
    _build.LAUNCHES["rmsnorm_sumsq"] += 1
    return out


def rmsnorm_scaled(x: torch.Tensor, ss: torch.Tensor, w: torch.Tensor, *, width: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(ss / width + eps) * (1 + w)``: x (..., D) the columns of
    rows ``width`` wide, ss (...) the rows' whole sums of squares, w (D,)."""
    if x.device.type == "cpu":
        return plain_scaled(x, ss, w, width=width, eps=eps)
    D = _require_rows("rmsnorm_scaled", x, ss, w)
    _build.require(w.shape == (D,) and ss.shape == x.shape[:-1] and width >= D,
                   f"rmsnorm_scaled: x {tuple(x.shape)}, ss {tuple(ss.shape)}, "
                   f"w {tuple(w.shape)}, width {width}")
    out = torch.empty_like(x)
    device, stream = _build.launch_site(x)
    err = _scaled()(x.data_ptr(), ss.data_ptr(), w.data_ptr(), out.data_ptr(),
                    x.numel() // D, D, width, eps, device, stream)
    _build.check(_build.library("rmsnorm"), err, "rmsnorm_scaled")
    _build.LAUNCHES["rmsnorm_scaled"] += 1
    return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain(x, w, eps=eps)
    D = _require_rows("rmsnorm", x, w)
    _build.require(w.shape == (D,), f"rmsnorm: D={D}, w {tuple(w.shape)}")
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


class RMSNormSumSqFn(torch.autograd.Function):
    """Forward through :func:`rmsnorm_sumsq`; backward ``2 x g``, by the
    plain version's VJP."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return rmsnorm_sumsq(x)

    @staticmethod
    def backward(ctx, g):
        return vjp(plain_sumsq, ctx.saved_tensors, g)[0]


class RMSNormScaledFn(torch.autograd.Function):
    """Forward through :func:`rmsnorm_scaled`, backward by the plain
    version's VJP."""

    @staticmethod
    def forward(ctx, x, ss, w, width, eps):
        ctx.save_for_backward(x, ss, w)
        ctx.width, ctx.eps = width, eps
        return rmsnorm_scaled(x, ss, w, width=width, eps=eps)

    @staticmethod
    def backward(ctx, gy):
        dx, dss, dw = vjp(plain_scaled, ctx.saved_tensors, gy, ctx.needs_input_grad[:3],
                          width=ctx.width, eps=ctx.eps)
        return dx, dss, dw, None, None
