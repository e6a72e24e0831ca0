"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.

[moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

vocab padded 49155 -> 49408; 24 heads padded to 32 for 16-way TP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,  # per-expert FFN width (fine-grained experts)
    vocab_size=49_155,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    num_experts=40,
    num_experts_per_tok=8,
    moe_layer_period=1,  # every layer MoE
    tie_embeddings=True,
    subquadratic=False,
)
