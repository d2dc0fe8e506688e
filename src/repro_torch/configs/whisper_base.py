"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is the frontend stub: the
caller delivers (B, 1500, 512) frame embeddings; the 6-layer encoder
transformer and the 6-layer decoder are the model.
"""

from repro_torch.configs.base import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    num_encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    use_rope=False,                     # learned decoder positions
    mlp_act="gelu_plain",
    stack_pattern=(("xdec", 6),),
    frontend=FrontendStub(kind="audio", num_positions=1500, feature_dim=512),
    max_position=524288,                # decoder position table (long variant)
    source="arXiv:2212.04356",
)
