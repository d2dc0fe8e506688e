"""paligemma-3b — SigLIP + Gemma-2B VLM [arXiv:2407.07726].

The SigLIP vision tower + projector is the frontend stub: the caller
delivers (B, 256, 2048) projected patch embeddings; the 18-layer Gemma
decoder (MQA kv=1, head_dim 256, geglu d_ff=16384) is the model.
"""

from repro_torch.configs.base import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    rope_theta=1e4,
    mlp_act="gelu",
    tie_embeddings=True,
    frontend=FrontendStub(kind="vision", num_positions=256, feature_dim=2048),
    source="arXiv:2407.07726",
)
