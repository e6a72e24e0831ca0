"""Mixture-of-Experts MLP of the PyTorch port (port of ``repro.models.moe``):
mixtral, granite and jamba.

Expert weights are stacked ``(E, d, f)`` / ``(E, f, d)``. The router takes
fp32 logits, the top-k of them (ties to the lower expert, as
``jax.lax.top_k``), and a softmax over the chosen k; a Switch-style
auxiliary load-balancing loss comes back with the output.

:func:`apply_moe_local` is the dense dispatch that the backbone calls
(:func:`apply_moe`, JAX's contract, makes its sums the aux loss): every
expert runs on every token and the combine weights mask the output. The
MoE has no Pallas kernel in the JAX package: its products are einsums, and
here batched matmuls. The two up-projections are one batched product over
the experts with the tokens broadcast to each (no copy of the expert
weights); the output contraction over (expert, hidden) is one GEMM against
``w_out`` viewed as ``(E * f, d)``, summed in fp32 and rounded to bf16 once,
as JAX's ``preferred_element_type=bf16``. :func:`apply_moe_topk_sparse` is
the gather form, held equal to it and not on the model's path.

Expert tensor parallelism (JAX ``moe.py:41-87``, on an ambient mesh with
``model`` > 1, ``distributed.constraint``): the experts stay whole in number
and their ``f`` is split over ``model``, ``w_in`` and ``w_gate`` by columns,
``w_out`` by rows. Routing (the router, its top-k, the aux loss) is computed
whole on every rank from the same bits. ``xt`` enters the expert products
behind ``copy_to_model``, and so do the ``combine`` weights where they meet
the local ``h`` (each rank's gradient of them covers its own ``f`` columns;
the router's gradient through the gates is their sum, and through the aux
loss already whole). Each rank's (T, d) partial is rounded to ``OUT_DTYPE``
once and then summed over ``model``.

The layer itself makes no collective over the data axes: the backbone calls
:func:`apply_moe_local`, which returns the rank's sums of the aux loss's
token means (:func:`aux_sums`), and ``lm.loss_fn``, the one reader of the
aux loss, takes them over the global batch once for all layers
(:func:`aux_loss`). Generation, whose data ranks may run different numbers
of decode steps, thus pairs no collective of the aux loss.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import constraint as tpc

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


def aux_sums(cfg: ModelConfig, logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """This rank's sums of the Switch load-balance loss's token means, (2E +
    1,) fp32: the tokens routed to each expert, each expert's summed router
    probability, and the token count."""
    e = cfg.num_experts
    return torch.cat([F.one_hot(idx, e).float().sum(dim=(0, 1)),
                      torch.softmax(logits, dim=-1).sum(dim=0),
                      logits.new_full((1,), float(logits.shape[0]))])


def aux_loss(cfg: ModelConfig, sums: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss ``E * sum_e density_e * p_mean_e`` from
    :func:`aux_sums` (..., 2E + 1), summed over the leading dims (the
    layers): density the share of tokens routed to each expert, p_mean the
    router's mean probability, each over the global batch. Where the
    ambient mesh's data axes split the batch the sums are summed over them
    first (``constraint.batch_sum``: one all-reduce for every layer)."""
    e = cfg.num_experts
    s = tpc.batch_sum(sums)
    n = s[..., 2 * e:]
    return e * torch.sum((s[..., :e] / n) * (s[..., e:2 * e] / n))


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
    scalar): :func:`apply_moe_local` with its sums made the aux loss."""
    out, sums = apply_moe_local(cfg, p, x)
    return out, aux_loss(cfg, sums)


def combine_to_model(combine: torch.Tensor) -> torch.Tensor:
    """The combine weights (T, E), replicated over ``model``, where they
    meet this rank's ``f`` columns: ``copy_to_model``, so that the router's
    gradient through the gates is the ranks' sum."""
    return tpc.copy_to_model(combine)


def apply_moe_local(cfg: ModelConfig, p: Params,
                    x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in ``OUT_DTYPE``, this rank's aux
    sums (2E + 1,), :func:`aux_sums`): the dense dispatch of
    ``moe.apply_moe``, with its order of roundings: the gates folded into h in h's dtype before the output
    contraction, summed in fp32 and rounded once. (JAX's transpose of that
    contraction rounds its gradients to bf16 as well; autograd here keeps
    the products' dtype, which is bf16 on the model's bf16 weights.)"""
    B, S, d = x.shape
    e, f = cfg.num_experts, p["w_in"].shape[-1]  # f: this rank's columns
    if f * tpc.tp_size() != cfg.d_ff:
        raise NotImplementedError(
            f"d_ff {cfg.d_ff} over {tpc.tp_size()} model ranks holds {f} a rank: experts "
            "whose f does not split evenly (ROADMAP queue 1, item 8: distributed)")
    xt = x.reshape(B * S, d)
    T = xt.shape[0]
    logits, gates, idx = route(cfg, p["router"], xt)
    combine = torch.zeros((T, e), dtype=torch.float32, device=x.device).scatter_add(1, idx, gates)
    sums = aux_sums(cfg, logits, idx)

    # (E, T, d) @ (E, d, f): the tokens broadcast over the experts' batch
    dt = torch.promote_types(x.dtype, p["w_in"].dtype)
    xe = tpc.copy_to_model(xt).to(dt).expand(e, T, d)
    h = torch.matmul(xe, p["w_in"].to(dt))
    g = torch.matmul(xe, p["w_gate"].to(dt)) if "w_gate" in p else None
    h = _activate(cfg, p, h, g)
    # gates folded in, the product laid out (T, E, f) (the contiguous
    # operand first sets the layout), so the contraction over (e, f) is one
    # GEMM against w_out's (E * f, d) view
    h = combine_to_model(combine)[:, :, None].to(h.dtype) * h.transpose(0, 1)
    out = h.reshape(T, e * f) @ p["w_out"].to(dt).reshape(e * f, d)
    return tpc.reduce_from_model(out.to(OUT_DTYPE or dt)).reshape(B, S, d), sums


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
    return out.reshape(B, S, d), aux_loss(cfg, aux_sums(cfg, logits, idx))
