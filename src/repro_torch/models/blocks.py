"""Blocks of the port (``repro.models.blocks``): the dense block only.

The MoE, MLA, SSM, hymba and whisper blocks wait for later slices."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.attention import Attention

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
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, **kw)

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
        return x + self.mlp(self.ln2(x))


BLOCKS = {"dense": DenseBlock}
