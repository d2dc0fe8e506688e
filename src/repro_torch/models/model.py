"""Model assembly (port of ``repro.models.model``): the block stack, and the
token model that serves the autoregressive path.

:class:`Backbone` is the block stack (the kinds of
:data:`repro_torch.models.blocks.BLOCKS`: dense, moe, mla_moe, mlstm,
slstm, hymba_swa, hymba_full), run segment by segment as the config's
``blocks`` lists them, and ``final_norm``; the diffusion denoiser runs it
on embedded states.  :class:`Model` adds the token embedding, the meta-token
prefix (hymba) and the LM head (tied to ``embed.T`` where the config ties
them) and mirrors the reference ``Model``'s ``forward``, cache, ``prefill``
and ``decode``.  The cache is one dict per segment, keyed
``"<i>_<kind>"`` as the reference keys it: a K/V ring for attention
segments, the latent ring for MLA, {"attn", "ssm"} for hymba, {"conv",
"c", "n", "m"} for mlstm and {"h", "c", "n", "m"} for slstm, each leaf
with a leading layer axis.  The meta tokens enter at train and prefill
time and sit in the protected first slots of every ring.  The reference
scans stacked per-layer parameters; here the layers are a ``ModuleList``
run in order.  The image-patch prefix and the audio and vision block kinds
wait for a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.blocks import BLOCKS

Tensor = torch.Tensor


class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        layers = []
        #: (cache key, first layer, layer count) of each segment
        self.segments = []
        for i, (kind, count) in enumerate(cfg.blocks):
            if kind not in BLOCKS:
                raise NotImplementedError(
                    f"block kind {kind!r} is not ported yet (ROADMAP, queue "
                    f"'modules to port', item 'Other denoiser families')"
                )
            self.segments.append((f"{i}_{kind}", len(layers), count))
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
        protected: int = 0,
    ) -> Tensor:
        """Run the stack on embedded states (B, S, d); ``lengths`` (B,)
        masks right-padding keys out of every attention softmax (the scans
        run left to right, so padding never reaches a valid position).  In
        the prefill and decode modes, layer ``j`` of a segment reads and
        writes layer ``j`` of the segment's cache; ``protected`` prefix
        slots are never evicted from a ring."""
        for key, first, count in self.segments:
            seg = None if cache is None else cache[key]
            for j in range(count):
                h = self.layers[first + j](
                    h, mode=mode, cache=seg, layer=j, pos=pos,
                    window_override=window_override, causal=causal,
                    lengths=lengths, protected=protected,
                )
        return self.final_norm(h)


class Model(nn.Module):
    """Token embedding + meta tokens + block stack + LM head, with a cache.

    Built on the card unless the caller passes ``device="cpu"``, with the
    reference's init rules drawn from a seeded ``torch.Generator``.  Weights
    are stored in the compute dtype, except those the reference computes
    with in float32 (norm scales, the MoE router, Mamba's ``A_log`` and
    ``D``, the sLSTM's recurrent weights); reference weights map in through
    :func:`repro_torch.interop.model_params_from_jax` and
    ``load_state_dict``.
    """

    def __init__(
        self, cfg: ModelConfig, *, device: str | torch.device | None = None,
        seed: int = 0,
    ):
        super().__init__()
        if cfg.kv_quant != "none":
            raise NotImplementedError(
                f"kv_quant={cfg.kv_quant!r}: the int8 KV cache is not ported "
                f"yet (ROADMAP, queue 'modules to port', item 'Autoregressive "
                f"path: the rest')"
            )
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        d = cfg.d_model
        self.config = cfg
        self.embed = nn.Parameter(
            L.init_tensor((cfg.padded_vocab, d), "embed", gen, dev, cfg.dtype),
            requires_grad=False,
        )
        self.meta = (
            nn.Parameter(
                L.init_tensor((cfg.num_meta_tokens, d), "embed", gen, dev,
                              cfg.dtype),
                requires_grad=False,
            )
            if cfg.num_meta_tokens else None
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
    def init_cache(self, batch: int, slots: int) -> dict:
        """The stack's decode cache: one entry per segment, keyed
        ``"<i>_<kind>"`` (see the module docstring); a windowed ring holds
        fewer than ``slots``."""
        cfg = self.config
        return {
            f"{i}_{kind}": BLOCKS[kind].init_cache(cfg, count, batch, slots,
                                                   self.device)
            for i, (kind, count) in enumerate(cfg.blocks)
        }

    def rings(self, cache: dict) -> list[dict]:
        """The attention rings of ``cache`` (each holds its slots'
        positions ``pos``), one per segment that attends over a cache."""
        out = []
        for i, (kind, _) in enumerate(self.config.blocks):
            ring = BLOCKS[kind].ring(cache[f"{i}_{kind}"])
            if ring is not None:
                out.append(ring)
        return out

    # ---- forward passes ----
    def _logits(self, h: Tensor) -> Tensor:
        if self.lm_head is None:
            return h @ self.embed.T.to(h.dtype)
        return self.lm_head(h)

    def _embed(self, tokens: Tensor, prefix: bool) -> Tensor:
        """Token embeddings, after the meta tokens where ``prefix`` (train
        and prefill; in decode they already sit in the cache)."""
        h = F.embedding(tokens, self.embed)
        if prefix and self.meta is not None:
            meta = self.meta.to(h.dtype).expand(h.shape[0], -1, -1)
            h = torch.cat([meta, h], dim=1)
        return h

    @torch.no_grad()
    def forward(self, tokens: Tensor) -> Tensor:
        """Teacher-forcing logits (B, num_meta_tokens + S, padded_vocab) of
        the whole sequence, meta positions included (the reference's
        ``forward``)."""
        h = self.backbone(self._embed(tokens, True), mode="train",
                          protected=self.config.num_meta_tokens)
        return self._logits(h)

    @torch.no_grad()
    def prefill(
        self, tokens: Tensor, slots: int, window_override: int = -1
    ) -> tuple[Tensor, dict]:
        """Process the prompts ``tokens`` (B, S) after the meta tokens;
        returns the last token's logits (B, 1, padded_vocab) and a new cache
        of ``slots`` slots (fewer in a windowed ring)."""
        cfg = self.config
        cache = self.init_cache(tokens.shape[0], slots)
        h = self._embed(tokens, True)
        for ring in self.rings(cache):
            A.cache_fill(ring, h.shape[1])
        h = self.backbone(
            h, mode="prefill", cache=cache, window_override=window_override,
            protected=cfg.num_meta_tokens,
        )
        return self._logits(h[:, -1:, :]), cache

    @torch.no_grad()
    def decode(
        self, cache: dict, tokens: Tensor, pos: int, window_override: int = -1
    ) -> tuple[Tensor, dict]:
        """One decode step: ``tokens`` (B, 1) at the absolute position
        ``pos`` (a host int, counting the meta tokens).  Updates ``cache``
        in place and returns the logits (B, 1, padded_vocab) and the
        cache."""
        protected = self.config.num_meta_tokens
        for ring in self.rings(cache):
            A.cache_insert(ring, pos, protected)
        h = self.backbone(
            self._embed(tokens, False), mode="decode", cache=cache, pos=pos,
            window_override=window_override, protected=protected,
        )
        return self._logits(h), cache


def build_model(
    cfg: ModelConfig, device: str | torch.device | None = None, seed: int = 0
) -> Model:
    """The token model of ``cfg``, on the card unless ``device="cpu"``."""
    return Model(cfg, device=device, seed=seed)
