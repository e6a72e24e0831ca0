"""Mamba2 SSD chunked scan: ``csrc/ssd.cu`` on CUDA tensors, the plain version
(``ref.ssd_chunked``) on CPU tensors. Port of ``repro.kernels.ssd.ssd``.

x (B, S, NH, P) bf16, dt (B, S, NH) f32, A and D (NH,) f32, Bm and Cm
(B, S, G, N) bf16 (head h reads group h // (NH // G)); returns (y (B, S, NH, P)
bf16, final state (B, NH, P, N) f32). ``chunk`` becomes ``min(chunk, S)``,
and ``S`` must be a multiple of it, as in the JAX package: nothing is padded.
The kernel takes a head dim of 64 and a state of 16, 32, 64 or 128 (every
SSD config's), and raises on any other. One chunk is one launch; past one
chunk the wrapper's one call is three launches (each chunk's state, the
recurrence over the chunks, each chunk's y) that pass the states through an
fp32 workspace of (B, NH, S / chunk, P, N).

:class:`SSDFn` is the autograd Function that ``ops.ssd`` takes when a
gradient is wanted (the SSD mixer's ``full`` mode in training): its forward
is :func:`ssd` (the kernel on a CUDA tensor), its backward the VJP of the
plain version at the same chunk, recomputed from the saved inputs. The JAX
package has no ``custom_vjp``: ``jax.grad`` differentiates the same plain
``ssd_chunked``, so this is its gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunked, vjp

_c = ctypes
HEAD_DIMS = (64,)
STATES = (16, 32, 64, 128)


def plain(x, dt, A, Bm, Cm, D, *, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (y, final state) of :func:`ref.ssd_chunked`."""
    return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=min(chunk, x.shape[1]), return_state=True)


@functools.lru_cache(maxsize=None)
def _fwd():
    return _build.entry("ssd", "ssd_fwd", [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_int,
        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p])


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, nh, p = x.shape
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd: seq {s} is not a multiple of the chunk {chunk}")
    if x.device.type == "cpu":
        return plain(x, dt, A, Bm, Cm, D, chunk=chunk)
    _build.require(x.device.type == "cuda", f"no ssd kernel for {x.device}")
    _build.require_no_grad("ssd", x, dt, A, Bm, Cm, D)
    _build.require_cuda(x, dt, A, Bm, Cm, D)
    _build.require(x.dtype == Bm.dtype == Cm.dtype == torch.bfloat16
                   and dt.dtype == A.dtype == D.dtype == torch.float32,
                   f"ssd kernel takes bf16 x/Bm/Cm and f32 dt/A/D, got {x.dtype}, "
                   f"{Bm.dtype}, {Cm.dtype}, {dt.dtype}, {A.dtype}, {D.dtype}")
    g, n = Bm.shape[2], Bm.shape[3]
    _build.require(dt.shape == (b, s, nh) and A.shape == D.shape == (nh,)
                   and Bm.shape == Cm.shape == (b, s, g, n) and nh % g == 0,
                   f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                   f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, D {tuple(D.shape)}")
    _build.require(p in HEAD_DIMS and n in STATES,
                   f"ssd kernel: head dim {p} (takes {HEAD_DIMS}), state {n} (takes {STATES})")
    y, h = launch(_fwd(), _build.library("ssd"), x, dt, A, Bm, Cm, D, chunk=chunk)
    _build.LAUNCHES["ssd"] += 1
    return y, h


def launch(fwd, lib, x, dt, A, Bm, Cm, D, *, chunk: int):
    """One call of ``ssd_fwd`` from ``lib`` (this module's build of
    ``csrc/ssd.cu``, or a probe build) on checked inputs: (y, final state)."""
    b, s, nh, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    nc = s // chunk
    y = torch.empty_like(x)
    h = torch.empty((b, nh, p, n), dtype=torch.float32, device=x.device)
    # past one chunk, scratch for each chunk's state and its a_tot
    ws = torch.empty((b, nh, nc, p, n) if nc > 1 else (0,), dtype=torch.float32,
                     device=x.device)
    a_tot = torch.empty((b, nh, nc) if nc > 1 else (0,), dtype=torch.float32, device=x.device)
    device, stream = _build.launch_site(x)
    err = fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
              D.data_ptr(), y.data_ptr(), h.data_ptr(), ws.data_ptr() or None,
              a_tot.data_ptr() or None, b, s, nh, g, p, n, chunk, device, stream)
    # a chunk, state or head dim whose tiles exceed a block's shared memory
    # fails here, at allow_smem
    _build.check(lib, err, f"ssd (chunk {chunk}, state {n}, head dim {p})")
    return y, h


class SSDFn(torch.autograd.Function):
    """Forward through :func:`ssd`, backward by the plain version's VJP.
    Returns (y, final state); either may go without a cotangent (training
    uses y only)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd(x, dt, A, Bm, Cm, D, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        grads = vjp(plain, ctx.saved_tensors, (gy, gh), ctx.needs_input_grad[:6],
                    chunk=ctx.chunk)
        return (*grads, None)
