"""deepseek-67b — dense llama-style, 95 layers.

[dense] 95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400
[arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=102_400,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    rope_theta=10_000.0,
    subquadratic=False,
)
