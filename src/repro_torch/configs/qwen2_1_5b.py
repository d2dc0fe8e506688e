"""qwen2-1.5b — dense GQA decoder with QKV bias [arXiv:2407.10671]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    mlp_act="silu",
    tie_embeddings=True,
    source="arXiv:2407.10671",
)
