"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attn [arXiv:2401.04088]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1e6,
    sliding_window=4096,
    mlp_act="silu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    source="arXiv:2401.04088",
)
