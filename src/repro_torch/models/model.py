"""The block stack of a model (port of ``repro.models.model``).

Only the part the diffusion denoiser runs is ported: the dense block stack
and ``final_norm`` (``Model.backbone``).  The token embedding and LM head
are left out because ``DiffusionLM.eps`` never reads them; the
autoregressive prefill / decode path waits for a later slice.  The
reference scans stacked per-layer parameters; here the layers are a
``ModuleList`` run in order.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.blocks import BLOCKS

Tensor = torch.Tensor


class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        layers = []
        for kind, count in cfg.blocks:
            if kind not in BLOCKS:
                raise NotImplementedError(f"block kind {kind!r} is not ported yet")
            layers += [
                BLOCKS[kind](cfg, generator=generator, device=device,
                             dtype=cfg.dtype)
                for _ in range(count)
            ]
        self.layers = nn.ModuleList(layers)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)

    def forward(
        self, h: Tensor, causal: bool = True, lengths: Tensor | None = None
    ) -> Tensor:
        """Run the stack on embedded states (B, S, d); ``lengths`` (B,)
        masks right-padding keys out of every attention softmax."""
        for layer in self.layers:
            h = layer(h, causal=causal, lengths=lengths)
        return self.final_norm(h)
