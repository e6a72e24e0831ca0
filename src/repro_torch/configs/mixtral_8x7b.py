"""mixtral-8x7b — MoE 8 experts top-2, sliding-window attention.

[moe] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2
[arXiv:2401.04088; hf]

SWA window 4096 bounds the decode KV cache -> sub-quadratic -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    num_experts=8,
    num_experts_per_tok=2,
    moe_layer_period=1,
    sliding_window=4096,
    subquadratic=True,  # SWA-bounded cache
)
