"""Mixture-of-Experts MLP of the PyTorch port (port of ``repro.models.moe``):
mixtral, granite and jamba.

Expert weights are stacked ``(E, d, f)`` / ``(E, f, d)``. The router takes
fp32 logits, the top-k of them (ties to the lower expert, as
``jax.lax.top_k``), and a softmax over the chosen k; a Switch-style
auxiliary load-balancing loss comes back with the output.

:func:`apply_moe` is the dense dispatch that the backbone calls: every
expert runs on every token and the combine weights mask the output. The
MoE has no Pallas kernel in the JAX package: its products are einsums, and
here batched matmuls. The two up-projections are one batched product over
the experts with the tokens broadcast to each (no copy of the expert
weights); the output contraction over (expert, hidden) is one GEMM against
``w_out`` viewed as ``(E * f, d)``, summed in fp32 and rounded to bf16 once,
as JAX's ``preferred_element_type=bf16``. :func:`apply_moe_topk_sparse` is
the gather form, held equal to it and not on the model's path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]

# the dtype of the dense dispatch's output contraction, as JAX's
# ``preferred_element_type=bf16``; None keeps the products' dtype (the fp32
# parity tests set it so in both packages: two fp32 sums that straddle a
# bf16 rounding boundary round one bf16 step apart)
OUT_DTYPE: Optional[torch.dtype] = torch.bfloat16


def init_moe(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> Params:
    """Router (d, E) f32 N(0, 1/d); ``w_in``, ``w_gate`` (E, d, f) N(0, 1/d)
    and ``w_out`` (E, f, d) N(0, 1/f), stored in bf16 (``moe.init_moe``),
    drawn from ``gen`` in that order."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale

    p: Params = {"router": normal((d, e), 1.0 / d**0.5),
                 "w_in": normal((e, d, f), 1.0 / d**0.5).to(torch.bfloat16),
                 "w_out": normal((e, f, d), 1.0 / f**0.5).to(torch.bfloat16)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = normal((e, d, f), 1.0 / d**0.5).to(torch.bfloat16)
    return p


def route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """(fp32 logits (T, E), top-k gates (T, k) softmaxed over the k, expert
    ids (T, k)). A stable descending sort puts the lower expert first on a
    tie, as ``jax.lax.top_k`` does (``torch.topk`` promises no order)."""
    logits = xt.float() @ router
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    return logits, torch.softmax(vals[:, :k], dim=-1), idx[:, :k]


def aux_loss(cfg: ModelConfig, logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss ``E * sum_e density_e * p_mean_e``: density
    the share of tokens routed to each expert, p_mean the router's mean
    probability."""
    e = cfg.num_experts
    density = F.one_hot(idx, e).float().sum(dim=1).mean(dim=0)
    p_mean = torch.softmax(logits, dim=-1).mean(dim=0)
    return e * torch.sum(density * p_mean)


def _activate(cfg: ModelConfig, p: Params, h: torch.Tensor, g) -> torch.Tensor:
    """The expert MLP's nonlinearity on the up-projection ``h`` (and the
    gate projection ``g`` of a gated MLP)."""
    if "w_gate" in p:
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        return act * h
    if cfg.mlp_type == "relu2":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in ``OUT_DTYPE``, aux loss fp32
    scalar): the dense dispatch of ``moe.apply_moe``, with its order of
    roundings: the gates folded into h in h's dtype before the output
    contraction, summed in fp32 and rounded once. (JAX's transpose of that
    contraction rounds its gradients to bf16 as well; autograd here keeps
    the products' dtype, which is bf16 on the model's bf16 weights.)"""
    B, S, d = x.shape
    e, f = cfg.num_experts, cfg.d_ff
    xt = x.reshape(B * S, d)
    T = xt.shape[0]
    logits, gates, idx = route(cfg, p["router"], xt)
    combine = torch.zeros((T, e), dtype=torch.float32, device=x.device).scatter_add(1, idx, gates)
    aux = aux_loss(cfg, logits, idx)

    # (E, T, d) @ (E, d, f): the tokens broadcast over the experts' batch
    dt = torch.promote_types(x.dtype, p["w_in"].dtype)
    xe = xt.to(dt).expand(e, T, d)
    h = torch.matmul(xe, p["w_in"].to(dt))
    g = torch.matmul(xe, p["w_gate"].to(dt)) if "w_gate" in p else None
    h = _activate(cfg, p, h, g)
    # gates folded in, the product laid out (T, E, f) (the contiguous
    # operand first sets the layout), so the contraction over (e, f) is one
    # GEMM against w_out's (E * f, d) view
    h = combine[:, :, None].to(h.dtype) * h.transpose(0, 1)
    out = h.reshape(T, e * f) @ p["w_out"].to(dt).reshape(e * f, d)
    return out.to(OUT_DTYPE or dt).reshape(B, S, d), aux


def apply_moe_topk_sparse(cfg: ModelConfig, p: Params,
                          x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather dispatch (``moe.apply_moe_topk_sparse``): only each token's
    top-k experts run, their weights gathered per token. Equal to
    :func:`apply_moe` within bf16 rounding; its output keeps the promoted
    dtype, as in JAX."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    logits, gates, idx = route(cfg, p["router"], xt)
    dt = torch.promote_types(x.dtype, p["w_in"].dtype)
    xt = xt.to(dt)
    h = torch.einsum("td,tkdf->tkf", xt, p["w_in"][idx].to(dt))
    g = torch.einsum("td,tkdf->tkf", xt, p["w_gate"][idx].to(dt)) if "w_gate" in p else None
    h = _activate(cfg, p, h, g)
    y = torch.einsum("tkf,tkfd->tkd", h, p["w_out"][idx].to(dt))
    out = torch.einsum("tkd,tk->td", y, gates.to(y.dtype))
    return out.reshape(B, S, d), aux_loss(cfg, logits, idx)
