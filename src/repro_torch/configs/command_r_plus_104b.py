"""command-r-plus-104b — dense, GQA, no-bias, parallel residual blocks.

[dense] 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33_792,
    vocab_size=256_000,
    norm_type="layernorm",
    mlp_type="swiglu",
    use_bias=False,
    parallel_block=True,  # Cohere parallel attn+MLP residual, shared norm
    rope_theta=10_000.0,
    subquadratic=False,
)
