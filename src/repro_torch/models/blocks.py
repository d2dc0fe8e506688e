"""Blocks of the port (``repro.models.blocks``): ``dense`` (llama / qwen /
minitron / deepseek-67b), ``moe`` (mixtral: GQA attention with its sliding
window, then the MoE FFN) and ``mla_moe`` (deepseek-v2-lite: MLA, then the
MoE FFN).  The MoE FFN's aux losses are dropped here; only training reads
them.  The SSM, hymba and whisper blocks wait for a later slice."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.attention import Attention
from repro_torch.models.mla import MLA
from repro_torch.models.moe import MoE

Tensor = torch.Tensor


class DenseBlock(nn.Module):
    """Pre-norm attention + MLP residual block (llama / qwen)."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, **kw)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self._build_ffn(cfg, kw)

    def _build_ffn(self, cfg, kw) -> None:
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, **kw)

    def _ffn(self, h: Tensor) -> Tensor:
        return self.mlp(h)

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, pos: int | None = None, window_override: int = -1,
        causal: bool = True, lengths: Tensor | None = None,
    ) -> Tensor:
        """``window_override`` < 0 keeps the block's own window (the
        reference's ``_window``); 0 is full attention, > 0 a window."""
        window = (
            self.cfg.sliding_window if window_override < 0 else window_override
        )
        h = self.ln1(x)
        x = x + self.attn(
            h, mode=mode, cache=cache, layer=layer, pos=pos, window=window,
            causal=causal, lengths=lengths,
        )
        return x + self._ffn(self.ln2(x))


class MoEBlock(DenseBlock):
    """The dense block with the MoE FFN in place of the MLP (mixtral)."""

    def _build_ffn(self, cfg, kw) -> None:
        self.moe = MoE(cfg, **kw)

    def _ffn(self, h: Tensor) -> Tensor:
        return self.moe(h)[0]


class MLAMoEBlock(nn.Module):
    """MLA + MoE FFN (deepseek-v2-lite).  MLA ignores ``window_override``
    and ``causal``, as the reference's ``mla_moe_apply`` does."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.mla = MLA(cfg, **kw)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.moe = MoE(cfg, **kw)

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, pos: int | None = None, window_override: int = -1,
        causal: bool = True, lengths: Tensor | None = None,
    ) -> Tensor:
        x = x + self.mla(self.ln1(x), mode=mode, cache=cache, layer=layer,
                         pos=pos, lengths=lengths)
        return x + self.moe(self.ln2(x))[0]


BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "mla_moe": MLAMoEBlock}
