"""mamba2-2.7b — SSD (state-space duality), attention-free.

[ssm] 64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,  # Mamba2 blocks carry no separate MLP
    vocab_size=50_280,
    norm_type="rmsnorm",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,  # d_inner = 5120 -> 80 SSD heads
    ssm_conv=4,
    ssm_ngroups=1,
    attn_layer_period=0,  # pure SSM
    subquadratic=True,  # constant-size decode state -> long_500k runs
    tie_embeddings=True,
)
