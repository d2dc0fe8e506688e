"""Blocks of the port (``repro.models.blocks``): ``dense`` (llama / qwen /
minitron / deepseek-67b), ``moe`` (mixtral: GQA attention with its sliding
window, then the MoE FFN), ``mla_moe`` (deepseek-v2-lite: MLA, then the
MoE FFN), ``mlstm`` and ``slstm`` (xlstm-350m, from
:mod:`repro_torch.models.ssm`) and ``hymba_swa`` / ``hymba_full``
(hymba-1.5b: attention and Mamba heads on one input, their normalized
outputs averaged, then the MLP), and whisper-base's ``enc`` (bidirectional
self-attention, layernorms, the plain GELU MLP) and ``xdec`` (causal
self-attention, cross-attention over the encoder's states where there are
any, the plain GELU MLP).  The blocks with a MoE FFN (``MOE = True``:
``moe``, ``mla_moe``) also take ``aux``, a list they append their layer's
aux losses ``{"moe_aux", "moe_z"}`` to; only training passes one
(:meth:`repro_torch.models.model.Backbone.forward`).

Every block takes ``(x, mode=, cache=, layer=, pos=, window_override=,
causal=, lengths=, protected=)``; ``cache`` is its segment's cache, with a
leading layer axis, and ``layer`` its index in the segment.  Each block
class also builds its segment's cache, ``init_cache(cfg, count, batch,
slots, device)``, as the reference's ``BlockDef.cache`` does, and finds
the attention ring in it, ``ring(cache)`` (the dict holding the slot
positions ``pos``; None for a kind that attends over no cache).  ``enc``
runs only in whisper's encoder, over the whole input, and so has neither;
``xdec`` also takes ``enc_out``, the encoder's states."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models import ssm as SSM
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

    @staticmethod
    def init_cache(cfg, count: int, batch: int, slots: int, device) -> dict:
        """A K/V ring; a sliding-window ring needs only the window plus the
        meta tokens (the reference's ``_slots_for``)."""
        if cfg.sliding_window > 0:
            slots = min(slots, cfg.sliding_window + cfg.num_meta_tokens)
        return _attn_cache(cfg, count, batch, slots, device)

    @staticmethod
    def ring(cache: dict) -> dict:
        return cache

    def _build_ffn(self, cfg, kw) -> None:
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, **kw)

    def _ffn(self, h: Tensor, aux: list | None = None) -> Tensor:
        return self.mlp(h)

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, pos: int | None = None, window_override: int = -1,
        causal: bool = True, lengths: Tensor | None = None,
        protected: int = 0, aux: list | None = None,
    ) -> Tensor:
        """``window_override`` < 0 keeps the block's own window (the
        reference's ``_window``); 0 is full attention, > 0 a window."""
        window = (
            self.cfg.sliding_window if window_override < 0 else window_override
        )
        h = self.ln1(x)
        x = x + self.attn(
            h, mode=mode, cache=cache, layer=layer, pos=pos, window=window,
            causal=causal, lengths=lengths, protected=protected,
        )
        return x + self._ffn(self.ln2(x), aux)


class MoEBlock(DenseBlock):
    """The dense block with the MoE FFN in place of the MLP (mixtral)."""

    MOE = True

    def _build_ffn(self, cfg, kw) -> None:
        self.moe = MoE(cfg, **kw)

    def _ffn(self, h: Tensor, aux: list | None = None) -> Tensor:
        out, losses = self.moe(h)
        if aux is not None:
            aux.append(losses)
        return out


class MLAMoEBlock(nn.Module):
    """MLA + MoE FFN (deepseek-v2-lite).  MLA ignores ``window_override``
    and ``causal``, as the reference's ``mla_moe_apply`` does."""

    MOE = True

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.mla = MLA(cfg, **kw)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.moe = MoE(cfg, **kw)

    @staticmethod
    def init_cache(cfg, count: int, batch: int, slots: int, device) -> dict:
        """The latent ring, every slot kept."""
        return M.init_cache(cfg, count, batch, slots, cfg.dtype, device)

    @staticmethod
    def ring(cache: dict) -> dict:
        return cache

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, pos: int | None = None, window_override: int = -1,
        causal: bool = True, lengths: Tensor | None = None,
        protected: int = 0, aux: list | None = None,
    ) -> Tensor:
        x = x + self.mla(self.ln1(x), mode=mode, cache=cache, layer=layer,
                         pos=pos, lengths=lengths)
        out, losses = self.moe(self.ln2(x))
        if aux is not None:
            aux.append(losses)
        return x + out


class HymbaBlock(nn.Module):
    """Hymba: attention and Mamba heads run on one rmsnormed input; their
    separately rmsnormed outputs are averaged into the residual, then the
    MLP.  ``hymba_swa`` attends in ``cfg.sliding_window``, ``hymba_full``
    over everything (window 0).  Its cache is {"attn": the K/V ring, "ssm":
    the Mamba state {"conv", "ssm"}}, each with a leading layer axis."""

    def __init__(self, cfg, *, generator, device, dtype, window: int):
        super().__init__()
        self.cfg = cfg
        self.window = window
        kw = dict(generator=generator, device=device, dtype=dtype)
        d = cfg.d_model
        self.ln1 = L.RMSNorm(d, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, **kw)
        self.mamba = SSM.Mamba(cfg, **kw)
        self.attn_norm = L.RMSNorm(d, cfg.norm_eps, device=device)
        self.mamba_norm = L.RMSNorm(d, cfg.norm_eps, device=device)
        self.ln2 = L.RMSNorm(d, cfg.norm_eps, device=device)
        self.mlp = L.MLP(d, cfg.d_ff, cfg.mlp_act, **kw)

    @staticmethod
    def ring_slots(cfg, slots: int) -> int:
        """The ring's slots: every slot (``hymba_full``); ``hymba_swa``
        keeps the window plus the meta tokens."""
        return slots

    @classmethod
    def init_cache(cls, cfg, count: int, batch: int, slots: int, device) -> dict:
        return {
            "attn": _attn_cache(cfg, count, batch, cls.ring_slots(cfg, slots),
                                device),
            "ssm": SSM.stacked(SSM.mamba_init_state(cfg, batch, cfg.dtype,
                                                    device), count),
        }

    @staticmethod
    def ring(cache: dict) -> dict:
        return cache["attn"]

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, pos: int | None = None, window_override: int = -1,
        causal: bool = True, lengths: Tensor | None = None,
        protected: int = 0,
    ) -> Tensor:
        window = self.window if window_override < 0 else window_override
        h = self.ln1(x)
        attn_out = self.attn(
            h, mode=mode, cache=None if cache is None else cache["attn"],
            layer=layer, pos=pos, window=window, causal=causal,
            protected=protected, lengths=lengths,
        )
        ssm = None if cache is None else cache["ssm"]
        mamba_out, state = self.mamba(h, SSM.layer_state(ssm, layer))
        SSM.store_layer_state(ssm, layer, state)
        fused = 0.5 * (self.attn_norm(attn_out) + self.mamba_norm(mamba_out))
        x = x + fused
        return x + self.mlp(self.ln2(x))


class HymbaSWABlock(HymbaBlock):
    def __init__(self, cfg, **kw):
        super().__init__(cfg, window=cfg.sliding_window, **kw)

    @staticmethod
    def ring_slots(cfg, slots: int) -> int:
        return min(slots, cfg.sliding_window + cfg.num_meta_tokens)


class HymbaFullBlock(HymbaBlock):
    def __init__(self, cfg, **kw):
        super().__init__(cfg, window=0, **kw)


class EncBlock(nn.Module):
    """Whisper encoder block: layernorm, bidirectional self-attention over
    the frames (train mode, no window), layernorm, plain GELU MLP."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = L.LayerNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, **kw)
        self.ln2 = L.LayerNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, "gelu_plain", **kw)

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, pos: int | None = None, window_override: int = -1,
        causal: bool = True, lengths: Tensor | None = None,
        protected: int = 0,
    ) -> Tensor:
        """Always the full sequence, not causal: the reference's
        ``enc_apply`` ignores the mode, window and causality it is given."""
        x = x + self.attn(self.ln1(x), causal=False, lengths=lengths)
        return x + self.mlp(self.ln2(x))


class XDecBlock(nn.Module):
    """Whisper decoder block: layernorm, self-attention (causal whatever
    ``causal`` says, as the reference's ``xdec_apply`` passes no causality:
    a whisper denoiser denoises left to right), then, where there are
    encoder states (``enc_out`` at train and prefill, the ``xk`` / ``xv``
    cache at decode), layernorm and cross-attention over them, then
    layernorm and the plain GELU MLP.  Without encoder states (the
    denoiser) the block runs decoder-only.  Its cache is {"self": the K/V
    ring, "xk", "xv": the encoder's K/V (count, B, F, KV, hd), written at
    prefill and read at decode, "xpos": their positions ``arange(F)``
    (int32), built once with the cache}."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        d = cfg.d_model
        self.ln1 = L.LayerNorm(d, cfg.norm_eps, device=device)
        self.self_attn = Attention(cfg, **kw)
        self.ln_x = L.LayerNorm(d, cfg.norm_eps, device=device)
        self.cross_attn = Attention(cfg, **kw)
        self.ln2 = L.LayerNorm(d, cfg.norm_eps, device=device)
        self.mlp = L.MLP(d, cfg.d_ff, "gelu_plain", **kw)

    @staticmethod
    def init_cache(cfg, count: int, batch: int, slots: int, device) -> dict:
        shape = (count, batch, cfg.frontend.num_positions, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {
            "self": _attn_cache(cfg, count, batch, slots, device),
            "xk": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "xv": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "xpos": torch.arange(shape[2], dtype=torch.int32, device=device),
        }

    @staticmethod
    def ring(cache: dict) -> dict:
        return cache["self"]

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, pos: int | None = None, window_override: int = -1,
        causal: bool = True, lengths: Tensor | None = None,
        protected: int = 0, enc_out: Tensor | None = None,
    ) -> Tensor:
        cfg = self.cfg
        window = cfg.sliding_window if window_override < 0 else window_override
        x = x + self.self_attn(
            self.ln1(x), mode=mode, cache=None if cache is None else cache["self"],
            layer=layer, pos=pos, window=window, lengths=lengths,
        )
        ek = ev = None
        if mode == "decode":
            ek, ev = cache["xk"][layer], cache["xv"][layer]
        elif enc_out is not None:
            b, f, _ = enc_out.shape
            shape = (b, f, cfg.num_kv_heads, cfg.resolved_head_dim)
            ek = self.cross_attn.wk(enc_out).reshape(shape)
            ev = self.cross_attn.wv(enc_out).reshape(shape)
            if mode == "prefill" and cache is not None:
                cache["xk"][layer] = ek
                cache["xv"][layer] = ev
        if ek is not None:  # no encoder states: decoder-only (the denoiser)
            if cache is not None:
                xpos = cache["xpos"]
            else:
                xpos = torch.arange(ek.shape[1], dtype=torch.int32,
                                    device=x.device)
            x = x + self.cross_attn(self.ln_x(x), mode=mode,
                                    cross_kv=(ek, ev, xpos))
        return x + self.mlp(self.ln2(x))


def _attn_cache(cfg, count, batch, slots, device):
    """A K/V ring, int8 under ``kv_quant="int8"`` as the reference's
    ``_attn_cache`` (dense, moe, hymba's ring, xdec's self-attention; the
    MLA latent ring and xdec's cross K/V ``xk`` / ``xv`` stay in the
    compute dtype, as the reference keeps them)."""
    return A.init_cache(count, batch, slots, cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.dtype, device,
                        quant=cfg.kv_quant == "int8")


BLOCKS = {
    "dense": DenseBlock, "moe": MoEBlock, "mla_moe": MLAMoEBlock,
    "mlstm": SSM.MLSTMBlock, "slstm": SSM.SLSTMBlock,
    "hymba_swa": HymbaSWABlock, "hymba_full": HymbaFullBlock,
    "enc": EncBlock, "xdec": XDecBlock,
}
