"""The shape half of the production workloads: the port of
``repro.launch.workloads``'s ``state_shapes``, ``caches_shapes`` and
``serve_param_mode``.

Shapes come from the model's own ``init`` and ``init_caches`` on the
``meta`` device, which allocates nothing, as ``jax.eval_shape`` does; the
sharding rules (``distributed.sharding``) read them at the production
meshes. The lowered programs (``build_*``) and the dry run belong to
ROADMAP queue 1, item 9.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.rl import trainer

# of the 16 GB HBM of the chip the JAX package sized its production meshes
# for: its serve layout is picked when weights + caches a device fit under it
HBM_BUDGET = 15.3e9


def _meta_model(cfg: ModelConfig):
    model = get_model(cfg, device="cpu")
    model.device = torch.device("meta")
    return model


def state_shapes(cfg: ModelConfig) -> trainer.TrainState:
    """A ``TrainState`` of ``meta`` tensors: the params and AdamW state of
    ``cfg``, nothing allocated."""
    params = _meta_model(cfg).init(torch.Generator())
    return trainer.TrainState(params=params, opt=adamw.init(params))


def caches_shapes(cfg: ModelConfig, batch: int, smax: int):
    """The decode caches of ``batch`` rows and ``smax`` slots, on ``meta``."""
    return _meta_model(cfg).init_caches(batch, smax)


def num_params(cfg: ModelConfig) -> int:
    """The JAX package's analytic parameter count (``ModelConfig.num_params``),
    which ``serve_param_mode`` reads."""
    d, v = cfg.d_model, cfg.padded_vocab
    total = v * d
    if not cfg.tie_embeddings:
        total += d * v
    hp = cfg.padded_heads
    gated = cfg.mlp_type in ("swiglu", "geglu")
    for mixer, mlp in cfg.layer_kinds():
        if mixer == "attn":
            total += 2 * d * hp * cfg.head_dim + 2 * d * cfg.num_kv_heads * cfg.head_dim
        else:
            din, g, ds, nh = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
            total += d * (2 * din + 2 * g * ds + nh)
            total += (din + 2 * g * ds) * cfg.ssm_conv
            total += 3 * nh + din
            total += din * d
        if mlp == "dense":
            total += d * cfg.d_ff * (3 if gated else 2)
        elif mlp == "moe":
            total += cfg.num_experts * d * cfg.d_ff * (3 if gated else 2)
            total += d * cfg.num_experts
        total += 2 * d
    if cfg.is_encoder_decoder:
        for _ in range(cfg.num_encoder_layers):
            total += 2 * d * hp * cfg.head_dim + 2 * d * cfg.num_kv_heads * cfg.head_dim
            total += d * cfg.d_ff * (3 if gated else 2) + 2 * d
        total += cfg.num_layers * (d * hp * cfg.head_dim * 2
                                   + 2 * d * cfg.num_kv_heads * cfg.head_dim)
    return int(total)


def serve_param_mode(cfg: ModelConfig, shape: ShapeConfig, mesh) -> str:
    """The decode weight layout: "serve" (TP only, weights resident, no
    per-step gathers) when weights + caches a device fit ``HBM_BUDGET``,
    else "train" (the FSDP layout, gathered every step)."""
    weight_bytes = num_params(cfg) * 2 / mesh.shape["model"]
    caches = caches_shapes(cfg, shape.global_batch, shape.seq_len)
    n_dev = math.prod(mesh.shape.values())
    cache_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(caches)
                      if t is not None) / n_dev
    return "serve" if weight_bytes + cache_bytes < HBM_BUDGET else "train"
