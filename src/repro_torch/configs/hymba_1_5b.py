"""hymba-1.5b — hybrid: parallel attention + Mamba heads per layer, meta
tokens, mostly-SWA with 3 full-attention layers [arXiv:2411.13676]."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    sliding_window=1024,
    num_meta_tokens=128,
    mlp_act="silu",
    stack_pattern=(
        ("hymba_full", 1), ("hymba_swa", 14),
        ("hymba_full", 1), ("hymba_swa", 15),
        ("hymba_full", 1),
    ),
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2, chunk=256),
    source="arXiv:2411.13676",
)
