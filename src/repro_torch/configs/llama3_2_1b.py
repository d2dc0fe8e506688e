"""llama3.2-1b — small Llama-3 dense decoder [hf:meta-llama/Llama-3.2-1B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    rope_theta=500000.0,
    mlp_act="silu",
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
