"""Mamba2 (SSD) mixer block of the PyTorch port (port of ``repro.models.ssm``).

Projections follow the Mamba2 layout: the input fans out to (z, x, B, C, dt);
a short depthwise causal conv runs over the x stream and over the (B, C)
stream; the SSD core (``ops.ssd``, the CUDA kernel on the card); a gated
RMSNorm; ``w_out`` back to d_model.

Tensor parallelism (JAX ``ssm.py:7-10``, on an ambient mesh with ``model`` =
M > 1, ``distributed.constraint``): each rank holds whole heads, ``nh / M``
of them: its columns of ``w_z``, ``w_x``, ``w_dt``, ``conv_x``, its entries
of ``A_log``, ``D``, ``dt_bias`` and ``norm_w``, and its rows of ``w_out``.
``u`` enters the column-parallel ``w_z``, ``w_x`` and ``w_dt`` behind
``copy_to_model``. The B/C stream (``w_B``, ``w_C``, ``conv_bc``, replicated)
is computed whole on every rank from ``u`` as it is, and ``Bm`` and ``Cm``
pass ``copy_to_model`` where they meet the local heads: their gradient is the
sum of every rank's heads', and ``u``'s share through them is then whole on
every rank (a ``copy_to_model`` on ``u`` there would sum it M times). The
scan runs on the local heads, the gated RMSNorm normalises over the whole
``d_inner`` (``ops.rmsnorm(width=)``: a sum of squares summed over the
ranks), and ``w_out`` is row-parallel before ``reduce_from_model``. The
decode state holds the local heads and ``conv_x`` channels, and ``conv_bc``
whole (:func:`ssm_state_shapes`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import constraint as tpc
from repro_torch.kernels import ops

Params = Dict[str, Any]


def init_ssm(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Params:
    """Random weights by the JAX package's scheme (``ssm.init_ssm``), drawn
    from ``gen`` in the order the JAX package splits its keys (w_z, w_x, w_B,
    w_C, w_dt, conv_x, the dt draw, conv_bc, then w_out). The numbers differ
    from ``jax.random``'s: use the bridge to run both on the same weights."""
    d = cfg.d_model
    din, g, n, nh = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    kw = cfg.ssm_conv

    def w(shape, s=1.0 / (d**0.5)):
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (t * s).to(torch.bfloat16)

    w_z, w_x = w((d, din)), w((d, din))
    w_B, w_C = w((d, g * n)), w((d, g * n))
    w_dt = w((d, nh))
    conv_x = w((kw, din), s=1.0 / kw)
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (the mamba2 init)
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    conv_bc = w((kw, 2 * g * n), s=1.0 / kw)
    w_out = w((din, d), s=1.0 / (din**0.5))
    return {
        "w_z": w_z, "w_x": w_x, "w_B": w_B, "w_C": w_C, "w_dt": w_dt,
        "conv_x": conv_x, "conv_bc": conv_bc,
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32, device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": dt_bias,
        "norm_w": torch.zeros((din,), dtype=torch.float32, device=device),
        "w_out": w_out,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x (B, S, C); w (K, C); state (B, K-1, C) or
    None (zeros). Returns (y (B, S, C) in x's dtype, new state (B, K-1, C)):
    the sum of the K shifted products, in order, as ``ssm._causal_conv``."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S+K-1, C)
    y = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y.to(x.dtype), new_state


def _local(cfg: ModelConfig, p: Params) -> Tuple[int, int]:
    """(SSD heads, d_inner columns) of this rank: all of them on one device,
    ``1 / model`` of them on a tensor-parallel mesh (heads split whole)."""
    nh, din = p["A_log"].shape[0], p["w_x"].shape[-1]
    if nh * tpc.tp_size() != cfg.ssm_nheads:
        raise NotImplementedError(
            f"{cfg.ssm_nheads} SSD heads over {tpc.tp_size()} model ranks hold {nh} a rank: "
            "heads that do not split evenly (ROADMAP queue 1, item 8: distributed)")
    return nh, din


def _in_proj(cfg: ModelConfig, p: Params, u: torch.Tensor):
    """(z, x, bc, dt) of ``u`` (B, S, d): dt is softplus(u w_dt + dt_bias)
    in fp32; z, x and dt this rank's heads, bc the whole B/C stream."""
    ul = tpc.copy_to_model(u)  # column-parallel w_z / w_x / w_dt (JAX: constrain(., dp, -, tp))
    z = ul @ p["w_z"]
    x = ul @ p["w_x"]
    bc = torch.cat([u @ p["w_B"], u @ p["w_C"]], dim=-1)
    dt = F.softplus((ul @ p["w_dt"]).float() + p["dt_bias"][None, None, :])
    return z, x, bc, dt


def _gated_out(cfg: ModelConfig, p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm (mamba2): norm(y * silu(z)) over the whole ``d_inner``
    through ``ops.rmsnorm``, then the row-parallel ``w_out``."""
    yz = y * F.silu(z)
    yn = ops.rmsnorm(yz.reshape(-1, yz.shape[-1]), p["norm_w"],
                     width=cfg.ssm_d_inner).reshape(yz.shape)
    return tpc.reduce_from_model(yn @ p["w_out"])


def apply_ssm(cfg: ModelConfig, p: Params, u: torch.Tensor, *, return_state: bool = False,
              chunk: int = 128):
    """Full-sequence SSD mixer (training and prefill). u (B, S, d); with
    ``return_state`` also the decode state {"ssm", "conv_x", "conv_bc"}
    after the sequence. ``chunk`` is the scan's chunk length (``ops.ssd``'s):
    ``S`` must be at most ``chunk`` or a multiple of it (ValueError). Every
    operation is differentiable: under grad mode the scan is ``ops.ssd``'s
    autograd Function."""
    B, S, _ = u.shape
    g, n, hd = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    nh, din = _local(cfg, p)
    z, x, bc, dt = _in_proj(cfg, p, u)
    x, conv_x_state = _causal_conv(x, p["conv_x"])
    bc, conv_bc_state = _causal_conv(bc, p["conv_bc"])
    x = F.silu(x)
    bc = F.silu(bc)
    # the kernel takes contiguous B and C: copy them out of the (B, C) stream
    Bm = tpc.copy_to_model(bc[..., :g * n].reshape(B, S, g, n).contiguous())
    Cm = tpc.copy_to_model(bc[..., g * n:].reshape(B, S, g, n).contiguous())
    A = -torch.exp(p["A_log"])
    y, h = ops.ssd(x.reshape(B, S, nh, hd), dt, A, Bm, Cm, p["D"], chunk=chunk,
                   return_state=True)
    out = _gated_out(cfg, p, y.reshape(B, S, din), z)
    if return_state:
        return out, {"ssm": h, "conv_x": conv_x_state, "conv_bc": conv_bc_state}
    return out


def ssm_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each leaf of one layer's decode state; on a
    tensor-parallel mesh this rank's heads and ``conv_x`` channels, and
    ``conv_bc`` whole. (JAX's ``cache_specs`` splits ``conv_bc``'s channels
    over ``model`` where they divide: a layout for GSPMD, which every rank's
    computation of the whole B/C stream gathers again. The port keeps it
    whole on every rank.)"""
    M = tpc.tp_size()
    din, g, n, nh, hd = (cfg.ssm_d_inner // M, cfg.ssm_ngroups, cfg.ssm_state,
                         cfg.ssm_nheads // M, cfg.ssm_headdim)
    kw = cfg.ssm_conv
    return {
        "ssm": ((batch, nh, hd, n), torch.float32),
        "conv_x": ((batch, kw - 1, din), torch.bfloat16),
        "conv_bc": ((batch, kw - 1, 2 * g * n), torch.bfloat16),
    }


def apply_ssm_decode(cfg: ModelConfig, p: Params, u: torch.Tensor,
                     state: Dict[str, torch.Tensor]):
    """One-token SSD step. u (B, 1, d); ``state`` from prefill or
    ``init_caches``. Returns (out (B, 1, d), new state)."""
    B = u.shape[0]
    g, n, hd = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    nh, din = _local(cfg, p)
    z, x, bc, dt = _in_proj(cfg, p, u)
    x, conv_x_state = _causal_conv(x, p["conv_x"], state["conv_x"])
    bc, conv_bc_state = _causal_conv(bc, p["conv_bc"], state["conv_bc"])
    x = F.silu(x)
    bc = F.silu(bc)
    Bm = tpc.copy_to_model(bc[:, 0, :g * n].reshape(B, g, n))
    Cm = tpc.copy_to_model(bc[:, 0, g * n:].reshape(B, g, n))
    A = -torch.exp(p["A_log"])
    y, h = ops.ssd_decode_step(x[:, 0].reshape(B, nh, hd), dt[:, 0], A, Bm, Cm, p["D"],
                               state["ssm"])
    out = _gated_out(cfg, p, y.reshape(B, 1, din), z)
    return out, {"ssm": h, "conv_x": conv_x_state, "conv_bc": conv_bc_state}
