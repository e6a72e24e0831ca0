"""qwen2.5-7b — the paper's own evaluation family (Qwen-2.5-Instruct).

Used by the RL pipeline benchmarks reproducing Figs. 9-14 (7B arm).
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    use_bias=False,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    subquadratic=False,
)
