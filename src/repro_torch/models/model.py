"""Model assembly (port of ``repro.models.model``): the block stack, and the
token model that serves the autoregressive path.

:class:`Backbone` is the block stack (the kinds of
:data:`repro_torch.models.blocks.BLOCKS`: dense, moe, mla_moe) and
``final_norm``; the diffusion denoiser runs it on embedded states.
:class:`Model` adds the token embedding and the LM head (tied to
``embed.T`` where the config ties them) and mirrors the reference
``Model``'s cache, ``prefill`` and ``decode``: a K/V cache for attention
stacks, the latent cache for MLA stacks.  The reference scans stacked
per-layer parameters; here the layers are a ``ModuleList`` run in order.
The meta-token and image-patch prefixes, and the SSM, hybrid, audio and
vision block kinds, wait for later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models.blocks import BLOCKS

#: block kinds whose decode cache is the attention K/V cache, and the MLA one
KV_CACHE_BLOCKS = frozenset({"dense", "moe"})
MLA_CACHE_BLOCKS = frozenset({"mla_moe"})

Tensor = torch.Tensor


class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        layers = []
        for kind, count in cfg.blocks:
            if kind not in BLOCKS:
                raise NotImplementedError(
                    f"block kind {kind!r} is not ported yet (ROADMAP, queue "
                    f"'modules to port', item 'Other denoiser families')"
                )
            layers += [
                BLOCKS[kind](cfg, generator=generator, device=device,
                             dtype=cfg.dtype)
                for _ in range(count)
            ]
        self.layers = nn.ModuleList(layers)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)

    def forward(
        self, h: Tensor, causal: bool = True, lengths: Tensor | None = None,
        *, mode: str = "train", cache: dict | None = None,
        pos: int | None = None, window_override: int = -1,
    ) -> Tensor:
        """Run the stack on embedded states (B, S, d); ``lengths`` (B,)
        masks right-padding keys out of every attention softmax.  In the
        prefill and decode modes, layer ``i`` reads and writes layer ``i``
        of ``cache`` (see :class:`repro_torch.models.attention.Attention`)."""
        for i, layer in enumerate(self.layers):
            h = layer(
                h, mode=mode, cache=cache, layer=i, pos=pos,
                window_override=window_override, causal=causal,
                lengths=lengths,
            )
        return self.final_norm(h)


class Model(nn.Module):
    """Token embedding + block stack + LM head, with a KV cache.

    Built on the card unless the caller passes ``device="cpu"``, with the
    reference's init rules drawn from a seeded ``torch.Generator``.  Every
    weight is stored in the compute dtype (``layers.py``); reference
    weights map in through :func:`repro_torch.interop.model_params_from_jax`
    and ``load_state_dict``.
    """

    def __init__(
        self, cfg: ModelConfig, *, device: str | torch.device | None = None,
        seed: int = 0,
    ):
        super().__init__()
        kinds = {kind for kind, _ in cfg.blocks}
        if not (kinds <= KV_CACHE_BLOCKS or kinds <= MLA_CACHE_BLOCKS):
            raise NotImplementedError(
                f"{cfg.name}: block kinds {sorted(kinds)} are not ported yet "
                f"(ROADMAP, queue 'modules to port', item 'Other denoiser "
                f"families')"
            )
        if cfg.kv_quant != "none":
            raise NotImplementedError(
                f"kv_quant={cfg.kv_quant!r}: the int8 KV cache is not ported "
                f"yet (ROADMAP, queue 'modules to port', item 'Autoregressive "
                f"path: the rest')"
            )
        if cfg.num_meta_tokens:
            raise NotImplementedError(
                "meta-token prefixes are not ported yet (ROADMAP, queue "
                "'modules to port', item 'Autoregressive path: the rest')"
            )
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        d = cfg.d_model
        self.config = cfg
        self.embed = nn.Parameter(
            L.init_tensor((cfg.padded_vocab, d), "embed", gen, dev, cfg.dtype),
            requires_grad=False,
        )
        self.backbone = Backbone(cfg, generator=gen, device=dev)
        self.lm_head = (
            None if cfg.tie_embeddings
            else L.Linear(d, cfg.padded_vocab, generator=gen, device=dev,
                          dtype=cfg.dtype)
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---- caches ----
    def _slots_for(self, kind: str, slots: int) -> int:
        """Sliding-window blocks only need ring buffers of window size (the
        reference's rule; MLA keeps every slot)."""
        cfg = self.config
        if kind in KV_CACHE_BLOCKS and cfg.sliding_window > 0:
            return min(slots, cfg.sliding_window + cfg.num_meta_tokens)
        return slots

    def init_cache(self, batch: int, slots: int) -> dict:
        """The stack's decode cache, by block kind: the K/V cache of an
        attention stack, or the latent cache of an MLA stack."""
        cfg = self.config
        kind = cfg.blocks[0][0]
        slots = self._slots_for(kind, slots)
        if kind in MLA_CACHE_BLOCKS:
            return MLA.init_cache(cfg, cfg.num_layers, batch, slots, cfg.dtype,
                                  self.device)
        return A.init_cache(
            cfg.num_layers, batch, slots, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.dtype, self.device,
        )

    # ---- forward passes ----
    def _logits(self, h: Tensor) -> Tensor:
        if self.lm_head is None:
            return h @ self.embed.T.to(h.dtype)
        return self.lm_head(h)

    @torch.no_grad()
    def prefill(
        self, tokens: Tensor, slots: int, window_override: int = -1
    ) -> tuple[Tensor, dict]:
        """Process the prompts ``tokens`` (B, S); returns the last token's
        logits (B, 1, padded_vocab) and a new cache of ``slots`` slots."""
        cache = self.init_cache(tokens.shape[0], slots)
        A.cache_fill(cache, tokens.shape[1])
        h = F.embedding(tokens, self.embed)
        h = self.backbone(
            h, mode="prefill", cache=cache, window_override=window_override
        )
        return self._logits(h[:, -1:, :]), cache

    @torch.no_grad()
    def decode(
        self, cache: dict, tokens: Tensor, pos: int, window_override: int = -1
    ) -> tuple[Tensor, dict]:
        """One decode step: ``tokens`` (B, 1) at the absolute position
        ``pos`` (a host int).  Updates ``cache`` in place and returns the
        logits (B, 1, padded_vocab) and the cache."""
        A.cache_insert(cache, pos)
        h = F.embedding(tokens, self.embed)
        h = self.backbone(
            h, mode="decode", cache=cache, pos=pos,
            window_override=window_override,
        )
        return self._logits(h), cache


def build_model(
    cfg: ModelConfig, device: str | torch.device | None = None, seed: int = 0
) -> Model:
    """The token model of ``cfg``, on the card unless ``device="cpu"``."""
    return Model(cfg, device=device, seed=seed)
