"""Model configuration: the :class:`ModelConfig` fields the dense family reads.

Ports ``repro.configs.base`` for the dense architectures the port serves
(qwen2-1.5b, llama3.2-1b), on the diffusion and the autoregressive paths.
Dtypes are torch dtypes.  The MoE / MLA / SSM / frontend sub-configs wait
for the slices that port those families.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # ---- attention ----
    head_dim: int = 0              # 0 => d_model // num_heads
    qkv_bias: bool = False         # Qwen2
    rope_theta: float = 1e4
    use_rope: bool = True
    max_position: int = 32768
    sliding_window: int = 0        # 0 => full attention
    long_context_window: int = 8192  # window of the long-context variant
    attn_logit_softcap: float = 0.0
    # ---- blocks ----
    stack_pattern: tuple[tuple[str, int], ...] = ()
    mlp_act: str = "silu"          # silu (swiglu) | gelu (geglu)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    num_meta_tokens: int = 0       # Hymba learnable prefix tokens
    # ---- numerics / system ----
    dtype: Any = torch.bfloat16    # compute dtype of the block stack
    vocab_pad_multiple: int = 2048  # the embedding's rows are padded to it
    kv_quant: str = "none"         # none | int8 (decode cache quantization)
    attention_impl: str = "auto"   # auto | naive | chunked | flash
    attn_chunk: int = 1024
    source: str = ""

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(math.ceil(self.vocab_size / m) * m)

    @property
    def blocks(self) -> tuple[tuple[str, int], ...]:
        if self.stack_pattern:
            return self.stack_pattern
        if self.family != "dense":
            raise ValueError(
                f"{self.name}: family {self.family!r} is not ported yet"
            )
        return (("dense", self.num_layers),)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced variant for CPU tests (same family, tiny dims) — the
        same reductions as the reference's ``ModelConfig.smoke``."""
        return self.with_(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            vocab_pad_multiple=64,
            max_position=512,
            head_dim=min(self.resolved_head_dim, 32),
            dtype=torch.float32,
            num_meta_tokens=min(self.num_meta_tokens, 8),
            sliding_window=(
                min(self.sliding_window, 64) if self.sliding_window else 0
            ),
            long_context_window=64,
            attn_chunk=64,
        )
