"""minitron-4b — width-pruned Nemotron-4 dense decoder [arXiv:2407.14679]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    rope_theta=1e4,
    mlp_act="silu",
    source="arXiv:2407.14679",
)
