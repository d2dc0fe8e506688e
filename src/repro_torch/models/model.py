"""Model assembly (port of ``repro.models.model``): the block stack, and the
token model that serves the autoregressive path.

:class:`Backbone` is the block stack (the kinds of
:data:`repro_torch.models.blocks.BLOCKS`: dense, moe, mla_moe, mlstm,
slstm, hymba_swa, hymba_full, xdec), run segment by segment as the config's
``blocks`` lists them, and ``final_norm`` (a layernorm for the audio
family, else an rmsnorm); the diffusion denoiser runs it on embedded
states.  :class:`Model` adds the token embedding (scaled by
``sqrt(d_model)`` for the vlm family, as Gemma scales it), the prefix
(hymba's meta tokens, paligemma's image patches), whisper's learned
decoder positions ``pos_embed`` and its ``encoder`` (the ``enc`` blocks
and a layernorm over the stub frames plus sinusoidal positions), and the
LM head (tied to ``embed.T`` where the config ties them), and mirrors the
reference ``Model``'s ``forward``, cache, ``prefill`` and ``decode``.  The cache is one dict per segment, keyed
``"<i>_<kind>"`` as the reference keys it: a K/V ring for attention
segments, the latent ring for MLA, {"attn", "ssm"} for hymba, {"conv",
"c", "n", "m"} for mlstm, {"h", "c", "n", "m"} for slstm and {"self",
"xk", "xv", "xpos"} for xdec, each leaf but xdec's ``xpos`` (the encoder
keys' positions) with a leading layer axis.  The meta
tokens and the image patches enter at train and prefill time (so decode
positions count them); the meta tokens sit in the protected first slots of
every ring.  The reference scans stacked per-layer parameters; here the
layers are a ``ModuleList`` run in order.
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
            self.segments.append((f"{i}_{kind}", len(layers), count))
            layers += [
                BLOCKS[kind](cfg, generator=generator, device=device,
                             dtype=cfg.storage_dtype)
                for _ in range(count)
            ]
        self.layers = nn.ModuleList(layers)
        self.final_norm = _norm(cfg, device)

    def forward(
        self, h: Tensor, causal: bool = True, lengths: Tensor | None = None,
        *, mode: str = "train", cache: dict | None = None,
        pos: int | None = None, window_override: int = -1,
        protected: int = 0, enc_out: Tensor | None = None,
        aux: dict | None = None,
    ) -> Tensor:
        """Run the stack on embedded states (B, S, d); ``lengths`` (B,)
        masks right-padding keys out of every attention softmax (the scans
        run left to right, so padding never reaches a valid position).  In
        the prefill and decode modes, layer ``j`` of a segment reads and
        writes layer ``j`` of the segment's cache; ``protected`` prefix
        slots are never evicted from a ring.  ``enc_out`` (whisper's
        encoder states, train and prefill) goes to the ``xdec`` blocks.
        With ``aux`` (a dict of float32 scalars ``moe_aux`` and ``moe_z``,
        training) the MoE blocks' aux losses are added into it: summed over
        each segment's layers, then over the segments, as the reference's
        ``_stack`` sums them."""
        extra = {} if enc_out is None else {"enc_out": enc_out}
        for key, first, count in self.segments:
            seg = None if cache is None else cache[key]
            seg_aux = []
            for j in range(count):
                layer = self.layers[first + j]
                more = ({"aux": seg_aux}
                        if aux is not None and getattr(layer, "MOE", False)
                        else {})
                h = layer(
                    h, mode=mode, cache=seg, layer=j, pos=pos,
                    window_override=window_override, causal=causal,
                    lengths=lengths, protected=protected, **extra, **more,
                )
            if seg_aux:
                for name in aux:
                    aux[name] = aux[name] + torch.stack(
                        [a[name] for a in seg_aux]).sum()
        return self.final_norm(h)


def zero_aux(device) -> dict:
    """The aux losses of a stack with no MoE block: float32 zeros (the
    reference's fixed schema)."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_aux": zero, "moe_z": zero}


def _norm(cfg: ModelConfig, device) -> nn.Module:
    """The final norm: a layernorm for the audio family, else an rmsnorm."""
    if cfg.family == "audio":
        return L.LayerNorm(cfg.d_model, cfg.norm_eps, device=device)
    return L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)


class Encoder(nn.Module):
    """Whisper's encoder: the ``enc`` blocks over the stub frame
    embeddings plus sinusoidal positions, then a layernorm (the
    reference's ``_encode``)."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        self.config = cfg
        self.layers = nn.ModuleList(
            BLOCKS["enc"](cfg, generator=generator, device=device,
                          dtype=cfg.storage_dtype)
            for _ in range(cfg.num_encoder_layers)
        )
        self.norm = L.LayerNorm(cfg.d_model, cfg.norm_eps, device=device)

    def forward(self, frames: Tensor) -> Tensor:
        """frames (B, F, d) -> encoder states (B, F, d) in the compute
        dtype; position p's embedding is ``sinusoidal_time_embed(p / 1000)``,
        rounded to the compute dtype before the add, as the reference does."""
        cfg = self.config
        t = torch.arange(frames.shape[1], dtype=torch.float32,
                         device=frames.device) / 1000.0
        pos = L.sinusoidal_time_embed(t, cfg.d_model)
        x = frames.to(cfg.dtype) + pos.to(cfg.dtype)
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class Model(nn.Module):
    """Token embedding + prefix + block stack + LM head, with a cache.

    Built on the card unless the caller passes ``device="cpu"``, with the
    reference's init rules drawn from a seeded ``torch.Generator``.  Weights
    are stored in the config's ``storage_dtype`` (the compute dtype unless
    ``param_dtype`` is set, as training sets it to float32), except those
    the reference computes with in float32 (norm scales and biases, the
    MoE router, Mamba's ``A_log`` and ``D``, the sLSTM's recurrent
    weights); reference weights map in through
    :func:`repro_torch.interop.model_params_from_jax` and
    ``load_state_dict``.
    """

    def __init__(
        self, cfg: ModelConfig, *, device: str | torch.device | None = None,
        seed: int = 0,
    ):
        super().__init__()
        if cfg.kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant={cfg.kv_quant!r}: 'none' or 'int8'")
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        d = cfg.d_model
        self.config = cfg
        self.embed = nn.Parameter(
            L.init_tensor((cfg.padded_vocab, d), "embed", gen, dev,
                          cfg.storage_dtype),
            requires_grad=False,
        )
        self.meta = (
            nn.Parameter(
                L.init_tensor((cfg.num_meta_tokens, d), "embed", gen, dev,
                              cfg.storage_dtype),
                requires_grad=False,
            )
            if cfg.num_meta_tokens else None
        )
        self.backbone = Backbone(cfg, generator=gen, device=dev)
        self.lm_head = (
            None if cfg.tie_embeddings
            else L.Linear(d, cfg.padded_vocab, generator=gen, device=dev,
                          dtype=cfg.storage_dtype)
        )
        audio = cfg.family == "audio"
        # whisper: learned decoder positions and the encoder
        self.pos_embed = (
            nn.Parameter(
                L.init_tensor((cfg.max_position, d), "embed", gen, dev,
                              cfg.storage_dtype),
                requires_grad=False,
            )
            if audio else None
        )
        self.encoder = Encoder(cfg, generator=gen, device=dev) if audio else None
        # Gemma scales its embeddings by sqrt(d_model), rounded to the
        # compute dtype first as the reference's jnp.asarray(.., dtype)
        # does (45.25 in bf16 at d_model 2048, not 45.2548)
        self.embed_scale = (
            float(torch.tensor(d**0.5, dtype=cfg.dtype))
            if cfg.family == "vlm" else None
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

    def _embed(self, tokens: Tensor, pos: int | None = None,
               patches: Tensor | None = None) -> Tensor:
        """Token embeddings (Gemma-scaled for the vlm family).  At train and
        prefill (``pos`` None) the prefix comes first: the meta tokens, then
        the image ``patches`` (vlm); in decode it already sits in the cache.
        The audio family adds its learned positions: ``[:S]``, or ``[pos]``
        in decode."""
        cfg = self.config
        h = F.embedding(tokens, self.embed).to(cfg.dtype)
        if self.embed_scale is not None:
            h = h * self.embed_scale
        if pos is None:
            prefix = []
            if self.meta is not None:
                prefix.append(self.meta.to(h.dtype).expand(h.shape[0], -1, -1))
            if cfg.family == "vlm":
                if patches is None:
                    raise ValueError(f"{cfg.name}: the vlm family takes "
                                     f"image patches at train and prefill")
                prefix.append(patches.to(h.dtype))
            if prefix:
                h = torch.cat([*prefix, h], dim=1)
        if self.pos_embed is not None:
            pe = (self.pos_embed[: h.shape[1]] if pos is None
                  else self.pos_embed[pos : pos + 1])
            h = h + pe.to(h.dtype)
        return h

    def _encode(self, frames: Tensor | None) -> Tensor | None:
        """The encoder's states over ``frames`` (audio family), else None."""
        if self.encoder is None:
            return None
        if frames is None:
            raise ValueError(f"{self.config.name}: the audio family takes "
                             f"frames at train and prefill")
        return self.encoder(frames)

    @torch.no_grad()
    def forward(self, tokens: Tensor, *, frames: Tensor | None = None,
                patches: Tensor | None = None) -> Tensor:
        """Teacher-forcing logits (B, prefix + S, padded_vocab) of the whole
        sequence, prefix positions (meta tokens, patches) included (the
        reference's ``forward``).  The audio family takes ``frames`` (B, F,
        d), the vlm family ``patches`` (B, P, d)."""
        return self.logits(tokens, frames=frames, patches=patches)

    def logits(self, tokens: Tensor, *, frames: Tensor | None = None,
               patches: Tensor | None = None,
               aux: dict | None = None) -> Tensor:
        """:meth:`forward` under autograd (no ``no_grad``); ``aux`` takes the
        MoE aux losses (:meth:`Backbone.forward`)."""
        h = self.backbone(self._embed(tokens, patches=patches), mode="train",
                          protected=self.config.num_meta_tokens,
                          enc_out=self._encode(frames), aux=aux)
        return self._logits(h)

    def loss(self, batch: dict) -> tuple[Tensor, dict]:
        """The reference's ``Model.loss``: teacher-forced cross-entropy of
        ``batch["tokens"]`` (B, S) after the prefix (meta tokens, the vlm
        family's ``patches``), each position predicting the next, in
        float32, averaged over the optional ``loss_mask`` (B, S); plus, with
        a MoE config, ``aux_loss_weight * moe_aux + router_z_loss * moe_z``.
        The audio family takes ``batch["frames"]``.  Returns (loss, {"xent",
        "moe_aux", "moe_z"})."""
        cfg = self.config
        tokens = batch["tokens"]
        patches = batch.get("patches")
        aux = zero_aux(tokens.device)
        logits = self.logits(tokens, frames=batch.get("frames"),
                             patches=patches, aux=aux)
        off = cfg.num_meta_tokens
        if cfg.family == "vlm":
            off += patches.shape[1]
        lg = logits[:, off:][:, :-1].to(torch.float32)
        tgt = tokens[:, 1:].to(torch.int64)
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
        mask = batch.get("loss_mask")
        mask = (torch.ones_like(logz) if mask is None
                else mask[:, 1:].to(torch.float32))
        xent = torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
        total = xent
        if cfg.moe is not None:
            total = (total + cfg.moe.aux_loss_weight * aux["moe_aux"]
                     + cfg.moe.router_z_loss * aux["moe_z"])
        return total, {"xent": xent, **aux}

    @torch.no_grad()
    def prefill(
        self, tokens: Tensor, slots: int, window_override: int = -1, *,
        frames: Tensor | None = None, patches: Tensor | None = None,
    ) -> tuple[Tensor, dict]:
        """Process the prompts ``tokens`` (B, S) after the prefix (meta
        tokens, ``patches``); returns the last token's logits (B, 1,
        padded_vocab) and a new cache of ``slots`` slots (fewer in a
        windowed ring); whisper's cache also takes the encoder's K/V of
        ``frames``."""
        cfg = self.config
        cache = self.init_cache(tokens.shape[0], slots)
        h = self._embed(tokens, patches=patches)
        for ring in self.rings(cache):
            A.cache_fill(ring, h.shape[1])
        h = self.backbone(
            h, mode="prefill", cache=cache, window_override=window_override,
            protected=cfg.num_meta_tokens, enc_out=self._encode(frames),
        )
        return self._logits(h[:, -1:, :]), cache

    @torch.no_grad()
    def decode(
        self, cache: dict, tokens: Tensor, pos: int, window_override: int = -1
    ) -> tuple[Tensor, dict]:
        """One decode step: ``tokens`` (B, 1) at the absolute position
        ``pos`` (a host int, counting the prefix).  Updates ``cache`` in
        place and returns the logits (B, 1, padded_vocab) and the cache."""
        protected = self.config.num_meta_tokens
        for ring in self.rings(cache):
            A.cache_insert(ring, pos, protected)
        h = self.backbone(
            self._embed(tokens, pos), mode="decode", cache=cache, pos=pos,
            window_override=window_override, protected=protected,
        )
        return self._logits(h), cache


def build_model(
    cfg: ModelConfig, device: str | torch.device | None = None, seed: int = 0
) -> Model:
    """The token model of ``cfg``, on the card unless ``device="cpu"``."""
    return Model(cfg, device=device, seed=seed)
