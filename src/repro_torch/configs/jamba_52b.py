"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]

Layer layout (period 8, matching the released Jamba v0.1): layer i uses
attention iff i % 8 == 4 (4 attention layers in 32 -> the paper's 1:7
attn:mamba ratio); layer i is MoE iff i % 2 == 1 (16 MoE layers).
SSM layers use the Mamba2/SSD formulation (TPU adaptation; see DESIGN.md §11).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    attn_layer_period=8,
    attn_layer_offset=4,
    num_experts=16,
    num_experts_per_tok=2,
    moe_layer_period=2,
    moe_layer_offset=1,
    ssm_state=16,  # Jamba v0.1 d_state; SSD kernel pads internally
    ssm_headdim=64,  # d_inner = 8192 -> 128 SSD heads
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=1,
    subquadratic=True,  # hybrid: bounded attn share -> long_500k runs
)
