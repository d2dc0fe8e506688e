"""xlstm-350m — sLSTM + mLSTM block stack [arXiv:2405.04517].

24 blocks at the paper's 7:1 mLSTM:sLSTM ratio -> (7m, 1s) x 3.
d_ff=0: xLSTM blocks carry their own gated up/down projections.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    stack_pattern=(
        ("mlstm", 7), ("slstm", 1),
        ("mlstm", 7), ("slstm", 1),
        ("mlstm", 7), ("slstm", 1),
    ),
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
