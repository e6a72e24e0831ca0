"""seamless-m4t-medium — encoder-decoder, multimodal (audio frontend stubbed).

[audio] 12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206
[arXiv:2308.11596; hf]

Backbone only: 12 encoder + 12 decoder layers. ``input_specs()`` supplies
precomputed audio frame embeddings (B, S_enc, d) — the speech frontend is a
stub per the assignment. Decoder: causal self-attn (cached) + cross-attn over
encoder memory. vocab padded 256206 -> 256256 for 16-way TP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,  # decoder layers
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,  # MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    norm_type="layernorm",
    mlp_type="gelu",
    use_bias=True,
    is_encoder_decoder=True,
    encoder_len=4096,  # encoder memory length for decode shapes
    num_prefix_embeds=1,  # marker: encoder input arrives as embeddings
    subquadratic=False,  # full attention -> long_500k skipped
)
