"""Model configuration dataclass (a copy of ``repro.configs.base``'s model part).

Every architecture is expressed as a :class:`ModelConfig`: a pure description
of the layer-kind layout, head counts and MoE/SSM settings. The PyTorch model
(``repro_torch.models``) interprets it; the launcher selects it via
``--arch <id>`` through :mod:`repro_torch.configs.registry`. The fields and
their defaults are those of the JAX package, so one config describes the same
model in both packages and the weight bridge can map one onto the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

VOCAB_ALIGN = 256  # pad vocab to multiples of this


def pad_to(x: int, align: int) -> int:
    return ((x + align - 1) // align) * align


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering dense / MoE / SSM / hybrid /
    enc-dec / VLM families."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int  # raw (pre-padding) vocabulary size

    # --- MLP / norm flavour ---
    mlp_type: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    use_bias: bool = False
    parallel_block: bool = False  # command-r style parallel attn+mlp residual
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)

    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # mixtral SWA
    # Layer-kind layout for hybrid archs. attn_layer_period==0 -> all layers
    # attention (dense); period p with offset o -> layer i is attention iff
    # i % p == o, otherwise the SSM mixer.
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_layer_period: int = 1  # layer i is MoE iff i % period == offset
    moe_layer_offset: int = 0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # --- enc-dec (seamless) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_len: int = 4096  # encoder memory length used by decode shapes

    # --- modality frontend stubs ---
    # Number of prefix embedding slots supplied pre-computed (ViT patches for
    # VLM, audio frames for audio archs). 0 = pure text.
    num_prefix_embeds: int = 0

    # --- numerics / layout ---
    dtype: str = "bfloat16"
    # int8 KV cache with per-slot-per-head scales (not ported yet)
    kv_quant: bool = False
    # Pad num_heads up to a multiple of this (zero heads; exact, their W_o
    # rows are zero). Reduced smoke configs set 1.
    pad_heads_to: int = 16
    # Sub-quadratic? (SSM/hybrid state, or bounded SWA window.)
    subquadratic: bool = False

    # ------------------------------------------------------------------ #
    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, VOCAB_ALIGN)

    @property
    def padded_heads(self) -> int:
        return pad_to(self.num_heads, self.pad_heads_to)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        if self.ssm_state == 0:
            return 0
        return self.ssm_d_inner // self.ssm_headdim

    # layer-kind helpers ------------------------------------------------ #
    def is_attn_layer(self, i: int) -> bool:
        if self.ssm_state == 0:
            return True
        if self.attn_layer_period == 0:
            return False  # pure SSM
        return i % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return i % self.moe_layer_period == self.moe_layer_offset

    def has_mlp(self) -> bool:
        """Pure Mamba2 blocks carry no separate MLP (d_ff == 0)."""
        return self.d_ff > 0

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """((mixer_kind, mlp_kind), ...) per layer.

        mixer_kind in {attn, ssm}; mlp_kind in {dense, moe, none}.
        """
        out = []
        for i in range(self.num_layers):
            mixer = "attn" if self.is_attn_layer(i) else "ssm"
            if not self.has_mlp():
                mlp = "none"
            elif self.is_moe_layer(i):
                mlp = "moe"
            else:
                mlp = "dense"
            out.append((mixer, mlp))
        return tuple(out)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=128 if cfg.d_ff > 0 else 0,
        vocab_size=256,
        pad_heads_to=1,
        sliding_window=16 if cfg.sliding_window else None,
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        num_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        encoder_len=32,
        num_prefix_embeds=8 if cfg.num_prefix_embeds else 0,
        name=cfg.name + "-smoke",
    )
    # keep layer-layout periods valid for the reduced depth
    if cfg.attn_layer_period:
        base["attn_layer_period"] = 4
        base["attn_layer_offset"] = 1
        base["num_layers"] = 4
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
