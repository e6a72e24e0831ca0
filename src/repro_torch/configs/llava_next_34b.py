"""llava-next-34b — VLM; dense backbone, anyres-tiled vision frontend (stub).

[vlm] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Backbone only per the assignment: ``input_specs()`` supplies precomputed
anyres patch embeddings (B, 2880, d_model) = 5 tiles x 576 patches,
concatenated ahead of the text tokens. 56 heads padded to 64 for 16-way TP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    num_prefix_embeds=2880,  # 5 anyres tiles x 576 CLIP patches
    subquadratic=False,
)
