"""Architecture registry of the port: ``get_config(name, smoke=...)``,
``long_context_policy`` and the reference's four input shapes
(``INPUT_SHAPES``, which the dry run builds a program for).

Every architecture of the reference's registry is ported: dense
(llama3.2-1b, qwen2-1.5b, minitron-4b, deepseek-67b), MoE (mixtral-8x7b,
deepseek-v2-lite-16b), SSM (xlstm-350m), hybrid (hymba-1.5b), audio
(whisper-base) and vlm (paligemma-3b)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

# public names (assignment ids) -> module names
ALIASES = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-67b": "deepseek_67b",
    "minitron-4b": "minitron_4b",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-base": "whisper_base",
    "paligemma-3b": "paligemma_3b",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def arch_names() -> list[str]:
    return sorted(ALIASES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALIASES.values():
        raise ValueError(
            f"unknown architecture {name!r}; "
            f"known: {arch_names()}"
        )
    cfg: ModelConfig = importlib.import_module(
        f"repro_torch.configs.{mod_name}"
    ).CONFIG
    return cfg.smoke() if smoke else cfg


def long_context_policy(cfg: ModelConfig) -> str:
    """How this arch runs a very long generation: ``native`` when it is
    sub-quadratic by construction (SSM / hybrid / native sliding window),
    ``swa`` when a dense arch is served with the sliding-window variant."""
    if cfg.family in ("ssm", "hybrid"):
        return "native"
    if cfg.sliding_window:
        return "native"
    return "swa"
