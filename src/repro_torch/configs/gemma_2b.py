"""gemma-2b — dense, MQA (kv=1), GeGLU, head_dim=256.

[dense] 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000
[arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,  # MQA
    head_dim=256,
    d_ff=16_384,
    vocab_size=256_000,
    norm_type="rmsnorm",
    mlp_type="geglu",
    tie_embeddings=True,
    embed_scale=True,  # embeddings scaled by sqrt(d_model)
    rope_theta=10_000.0,
    # 8 heads not divisible by 16-way TP -> padded to 16 (zero heads; exact,
    # W_o columns zero). See DESIGN.md §6.
    pad_heads_to=16,
    subquadratic=False,
)
