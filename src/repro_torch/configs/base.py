"""Model configuration: :class:`ModelConfig` and its MoE / MLA / SSM /
frontend sub-configs.

Ports ``repro.configs.base`` for every family of the reference: dense
(qwen2-1.5b, llama3.2-1b, minitron-4b, deepseek-67b), MoE (mixtral-8x7b
with the ``moe`` block, deepseek-v2-lite-16b with ``mla_moe``), SSM
(xlstm-350m: ``mlstm`` and ``slstm``), hybrid (hymba-1.5b: ``hymba_full``
and ``hymba_swa``, with meta tokens), audio (whisper-base: an ``enc``
encoder over stub frames and ``xdec`` decoder blocks) and vlm
(paligemma-3b: dense blocks after stub image patches), on the diffusion
and the autoregressive paths.  Dtypes are torch dtypes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0            # always-active shared experts (DeepSeek)
    capacity_factor: float = 1.25
    dispatch_group: int = 4096     # tokens per capacity group
    router_z_loss: float = 1e-3
    aux_loss_weight: float = 1e-2
    # dispatch strategy: "dropping" (capacity scatter, default) or
    # "dense_mix" (every expert on every token: the test oracle)
    dispatch: str = "dropping"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 => full-rank q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (Hymba heads) / xLSTM cells."""

    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2                # d_inner = expand * d_model
    dt_rank: int = 0               # 0 => ceil(d_model / 16)
    chunk: int = 256               # chunked-scan length


@dataclasses.dataclass(frozen=True)
class FrontendStub:
    """Modality frontend carve-out: precomputed embeddings of this shape."""

    kind: str                      # "audio" | "vision"
    num_positions: int             # frames or patches
    feature_dim: int               # embedding dim delivered to the backbone


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
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
    use_rope: bool = True          # Whisper decoder uses learned pos emb
    max_position: int = 32768
    sliding_window: int = 0        # 0 => full attention
    long_context_window: int = 8192  # window of the long-context variant
    attn_logit_softcap: float = 0.0
    # ---- blocks ----
    stack_pattern: tuple[tuple[str, int], ...] = ()
    mlp_act: str = "silu"          # silu (swiglu) | gelu (geglu) | gelu_plain
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # ---- substructures ----
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    frontend: FrontendStub | None = None
    num_meta_tokens: int = 0       # Hymba learnable prefix tokens
    # ---- encoder-decoder ----
    num_encoder_layers: int = 0    # Whisper
    # ---- numerics / system ----
    dtype: Any = torch.bfloat16    # compute dtype of the block stack
    # storage dtype of the weights the block stack casts to ``dtype`` at
    # use; None stores them in ``dtype`` (serving).  Training passes
    # float32, the reference's default: AdamW's steps of ~lr relative are
    # below bf16's resolution and would not move bf16 weights.
    param_dtype: Any = None
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
    def storage_dtype(self):
        """The dtype the weights cast at use are stored in."""
        return self.param_dtype or self.dtype

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(math.ceil(self.vocab_size / m) * m)

    @property
    def blocks(self) -> tuple[tuple[str, int], ...]:
        if self.stack_pattern:
            return self.stack_pattern
        default = {
            "dense": "dense", "moe": "moe", "vlm": "dense", "audio": "dense",
        }.get(self.family)
        if default is None:
            raise ValueError(
                f"{self.name}: family {self.family!r} needs an explicit "
                "stack_pattern"
            )
        return ((default, self.num_layers),)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced variant for CPU tests (same family, tiny dims) — the
        same reductions as the reference's ``ModelConfig.smoke``."""
        kw: dict[str, Any] = dict(
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
            num_encoder_layers=min(self.num_encoder_layers, 2),
            sliding_window=(
                min(self.sliding_window, 64) if self.sliding_window else 0
            ),
            long_context_window=64,
            attn_chunk=64,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 128),
                num_shared=min(self.moe.num_shared, 1),
            )
        if self.mla:
            kw["mla"] = dataclasses.replace(
                self.mla,
                kv_lora_rank=64,
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
            )
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, chunk=32)
        if self.frontend:
            kw["frontend"] = dataclasses.replace(
                self.frontend, num_positions=16, feature_dim=kw["d_model"]
            )
        if self.stack_pattern:
            # shrink the pattern to 2 layers, keeping >=1 of each block kind
            kinds = []
            for kind, _ in self.stack_pattern:
                if kind not in kinds:
                    kinds.append(kind)
            kw["stack_pattern"] = tuple((k, 1) for k in kinds[:2]) or ()
            kw["num_layers"] = sum(c for _, c in kw["stack_pattern"])
        return self.with_(name=self.name + "-smoke", **kw)
