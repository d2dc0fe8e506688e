"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

MLA kv_lora_rank=512; 64 routed experts (top-6) + 2 shared experts,
expert d_ff=1408.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    rope_theta=1e4,
    mlp_act="silu",
    stack_pattern=(("mla_moe", 27),),
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
    source="arXiv:2405.04434",
)
