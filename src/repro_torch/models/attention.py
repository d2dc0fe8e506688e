"""GQA attention with a KV cache — port of ``repro.models.attention``.

Three SDPA implementations for the full-sequence modes (train, prefill),
chosen by ``impl``:

* ``naive``   — materializes (Sq, Sk) scores (the reference's
  ``_naive_sdpa``, same dtype behaviour);
* ``chunked`` — streaming softmax over KV chunks (``_chunked_sdpa``);
* ``flash``   — :func:`repro_torch.kernels.flash_attention.flash_attention`,
  the hand-written kernel on the card.

CUDA tensors always take ``flash`` (``auto`` or ``flash``; naming a plain
version for them raises).  For CPU tensors ``auto`` picks naive or chunked
by the reference's size rule.  Masking is positional (every key
carries an absolute position) plus an optional per-row ``kv_mask``.

Decode (one token over the cache) goes through
:func:`repro_torch.kernels.decode_attention.decode_attention`: the
hand-written kernel on the card, its plain version for CPU tensors.  The
reference's decode picks naive SDPA (its Pallas decode kernel is reached
only by its kernel tests); the port routes decode to its kernel the way
it routes the full-sequence modes to ``flash``.

The KV cache keeps the reference's semantics (slots carry absolute
positions, -1 = empty; ring slot ``pos % slots``, or ``protected + (pos -
protected) % ring`` past protected prefix slots; a prefill longer than the
cache keeps its last ``slots`` entries) in one dict per model: ``k`` and
``v`` of shape (L, B, slots, KV, hd) and one ``pos`` (slots,) int32, where
the reference stacks an identical ``pos`` for every layer.  The reference
donates its cache buffers to each jitted decode step; the port updates
the cache tensors in place instead.  Cross-attention (whisper's
decoder over the encoder's states) takes the same two kernels: ``flash``
at train and prefill, the decode kernel's non-causal mode at decode.  The
banded windowed prefill (``_banded_sdpa``, a faster layout of the same
windowed attention) needs no port: the windowed flash kernel computes the
same function.

With ``kv_quant="int8"`` (:func:`init_cache` with ``quant=True``) the
cache holds int8 ``k`` / ``v`` and float32 ``k_scale`` / ``v_scale`` (L,
B, slots, KV, 1), symmetric per (token, head) as the reference's
``_quantize``: every write quantizes (:func:`cache_write`), and decode
dequantizes the layer's whole cache to the compute dtype before the decode
kernel reads it (:func:`cache_kv`, the reference's ``cache_kv``).  The
prefill attends over its fresh K/V, as the reference's does.  So an int8
decode step moves more bytes than a bf16 one (it reads int8, then writes
and reads the bf16 copy): the int8 cache saves memory, not time, until the
decode kernel reads int8 itself (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

Tensor = torch.Tensor
NEG_INF = -1e30


def _kv_mask_bias(kv_mask: Tensor) -> Tensor:
    """(B, Sk) key-validity mask -> additive bias (exact 0.0 where valid)."""
    zero = torch.zeros((), device=kv_mask.device)
    return torch.where(kv_mask != 0, zero, torch.full_like(zero, NEG_INF))


def _mask_bias(
    q_pos: Tensor, kv_pos: Tensor, window: int, causal: bool,
    protected: int = 0,
) -> Tensor:
    """(Sq, Sk) additive float32 bias from absolute positions."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    valid = k >= 0
    if causal:
        valid = valid & (k <= q)
    if window > 0:
        in_window = k > q - window
        if protected > 0:  # attention sinks are always visible
            in_window = in_window | (k < protected)
        valid = valid & in_window
    zero = torch.zeros((), device=q_pos.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def _softcap(x: Tensor, cap: float) -> Tensor:
    return cap * torch.tanh(x / cap) if cap > 0.0 else x


def _naive_sdpa(
    q, k, v, q_pos, kv_pos, *, window, causal, softcap, protected=0,
    kv_mask=None,
):
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    scores = _softcap(scores * hd**-0.5, softcap)
    scores = scores + _mask_bias(q_pos, kv_pos, window, causal, protected)
    if kv_mask is not None:
        scores = scores + _kv_mask_bias(kv_mask)[:, None, None, None, :]
    w = torch.softmax(scores, dim=-1)
    # fully masked rows -> zeros, matching the kernel
    any_valid = torch.amax(scores, dim=-1, keepdim=True) > NEG_INF / 2
    w = torch.where(any_valid, w, torch.zeros((), device=w.device))
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def _chunked_sdpa(
    q, k, v, q_pos, kv_pos, *, window, causal, softcap, chunk, protected=0,
    kv_mask=None,
):
    """Streaming-softmax attention over KV chunks."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    nchunks = -(-sk // chunk)
    pad = nchunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
        if kv_mask is not None:
            kv_mask = F.pad(kv_mask, (0, pad))
    qg = (q * hd**-0.5).reshape(b, sq, kvh, g, hd)
    hd_v = v.shape[-1]
    acc = torch.zeros((b, sq, kvh, g, hd_v), dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    zero = torch.zeros((), device=q.device)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kj, vj = k[:, sl], v[:, sl]
        s = torch.einsum("bqkgd,bskd->bqkgs", qg, kj).to(torch.float32)
        s = _softcap(s, softcap)
        bias = _mask_bias(q_pos, kv_pos[sl], window, causal, protected)
        s = s + bias[None, :, None, None, :]
        if kv_mask is not None:
            s = s + _kv_mask_bias(kv_mask[:, sl])[:, None, None, None, :]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # guard both exps below the mask floor so fully masked rows keep
        # (acc, l) at exact zero and finalize to zeros
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]), zero)
        scale = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), zero)
        acc = acc * scale[..., None] + torch.einsum(
            "bqkgs,bskd->bqkgd", p.to(vj.dtype), vj
        ).to(torch.float32)
        l = l * scale + torch.sum(p, dim=-1)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, hd_v).to(q.dtype)


def resolve_impl(impl: str, device: torch.device, sq: int, sk: int) -> str:
    """CUDA tensors take the kernels; so do ``meta`` tensors, whose kernel
    wrappers charge the dry run's counter with the work of the program the
    card runs."""
    if device.type in ("cuda", "meta"):
        if impl not in ("auto", "flash"):
            raise ValueError(
                f"attention impl {impl!r} is a plain version for CPU tensors; "
                f"CUDA tensors take the hand-written kernels"
            )
        return "flash"
    if impl != "auto":
        return impl
    return "naive" if sq * sk <= 1024 * 2048 else "chunked"


def check_decode(impl: str, device: torch.device, softcap: float) -> None:
    """Decode takes the decode kernel for CUDA tensors (naming a plain impl
    for them raises) and its plain version for CPU tensors.  Neither has a
    softcap, like the TPU decode kernel: no ported architecture sets one."""
    resolve_impl(impl, device, 1, 1)
    if softcap > 0.0:
        raise ValueError(
            f"decode attention has no softcap (got {softcap}); no ported "
            f"architecture sets one"
        )


def sdpa(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    q_pos: Tensor,
    kv_pos: Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    softcap: float = 0.0,
    impl: str = "auto",
    chunk: int = 1024,
    protected: int = 0,
    kv_mask: Tensor | None = None,
) -> Tensor:
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, hd_v) (hd_v may
    differ from hd, as in MLA); ``kv_mask`` an optional (B, Sk) per-row
    key-validity mask (right-padded mixed-length rows).  Returns (B, Sq, H,
    hd_v)."""
    sq, sk = q.shape[1], k.shape[1]
    impl = resolve_impl(impl, q.device, sq, sk)
    kw = dict(window=window, causal=causal, softcap=softcap,
              protected=protected, kv_mask=kv_mask)
    if impl == "naive":
        return _naive_sdpa(q, k, v, q_pos, kv_pos, **kw)
    if impl == "chunked":
        return _chunked_sdpa(
            q, k, v, q_pos, kv_pos, chunk=min(chunk, max(sk, 128)), **kw
        )
    if impl == "flash":
        return flash_attention(
            q, k, v, q_pos.to(torch.int32), kv_pos.to(torch.int32), **kw
        )
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# KV cache: one per model, updated in place
# ---------------------------------------------------------------------------


def init_cache(
    num_layers: int, batch: int, slots: int, kv_heads: int, head_dim: int,
    dtype, device, quant: bool = False,
) -> dict:
    """An empty cache: zero K/V and every slot position -1.  ``quant``:
    int8 K/V with float32 per-(token, head) scales (L, B, slots, KV, 1)."""
    shape = (num_layers, batch, slots, kv_heads, head_dim)
    pos = torch.full((slots,), -1, dtype=torch.int32, device=device)
    if quant:
        scale = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scale, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(scale, dtype=torch.float32, device=device),
            "pos": pos,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": pos,
    }


def _quantize(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric int8 per (token, head), as the reference's ``_quantize``:
    scale ``max|x| / 127`` over the head dim in float32, floored at 1e-8;
    values ``clip(round(x / scale), -127, 127)`` (round half to even, as
    ``jnp.round``).  x: (B, S, KV, hd) -> (int8 (B, S, KV, hd), float32
    (B, S, KV, 1))."""
    x32 = x.to(torch.float32)
    scale = torch.amax(torch.abs(x32), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequant(q: Tensor, scale: Tensor, dtype) -> Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def cache_slot(pos: int, slots: int, protected: int = 0) -> int:
    """Ring slot of absolute position ``pos`` (a host int, so choosing the
    slot costs no device sync)."""
    if 0 < protected < slots:
        if pos < protected:
            return pos
        return protected + (pos - protected) % (slots - protected)
    return pos % slots


def cache_insert(cache: dict, pos: int, protected: int = 0) -> int:
    """Record one decode step at absolute position ``pos`` in the shared
    slot positions; returns the slot every layer writes its K/V to
    (:func:`cache_write`)."""
    slot = cache_slot(pos, cache["pos"].shape[0], protected)
    cache["pos"][slot] = pos
    return slot


def cache_fill(cache: dict, s: int) -> int:
    """Record a prefill of ``s`` steps from position 0; returns how many of
    them the cache keeps — the last ``min(s, slots)``, written from slot 0
    on, as the reference does."""
    slots = cache["pos"].shape[0]
    keep = min(s, slots)
    cache["pos"][:keep] = torch.arange(
        s - keep, s, dtype=torch.int32, device=cache["pos"].device
    )
    return keep


def cache_write(cache: dict, layer: int, k: Tensor, v: Tensor, slot: int) -> None:
    """Write ``k``/``v`` (B, n, KV, hd) of ``layer`` at slots
    ``slot .. slot + n``, in place (quantized first in an int8 cache)."""
    n = k.shape[1]
    if cache["k"].dtype == torch.int8:
        (k, ks), (v, vs) = _quantize(k), _quantize(v)
        cache["k_scale"][layer, :, slot : slot + n] = ks
        cache["v_scale"][layer, :, slot : slot + n] = vs
    cache["k"][layer, :, slot : slot + n] = k
    cache["v"][layer, :, slot : slot + n] = v


def cache_kv(cache: dict, layer: int, dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """K/V of ``layer``, (B, slots, KV, hd): views of the cache, or, in an
    int8 cache, the whole layer dequantized to ``dtype``."""
    if cache["k"].dtype == torch.int8:
        return (_dequant(cache["k"][layer], cache["k_scale"][layer], dtype),
                _dequant(cache["v"][layer], cache["v_scale"][layer], dtype))
    return cache["k"][layer], cache["v"][layer]


class Attention(nn.Module):
    """Projections + rope + SDPA in the train, prefill and decode modes."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wq = L.Linear(d, h * hd, bias=cfg.qkv_bias, **kw)
        self.wk = L.Linear(d, kvh * hd, bias=cfg.qkv_bias, **kw)
        self.wv = L.Linear(d, kvh * hd, bias=cfg.qkv_bias, **kw)
        self.wo = L.Linear(h * hd, d, **kw)

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, pos: int | None = None, window: int = 0,
        causal: bool = True, protected: int = 0,
        lengths: Tensor | None = None,
        cross_kv: tuple[Tensor, Tensor, Tensor] | None = None,
    ) -> Tensor:
        """``mode``: ``train`` (the full sequence, no cache), ``prefill``
        (causal over the prompt at positions ``arange(S)``, also filling
        ``layer`` of ``cache``) or ``decode`` (one token at the host-int
        absolute position ``pos``: its K/V go into ``layer`` of ``cache``,
        whose slot positions the caller has already recorded with
        :func:`cache_insert`, and the query attends over the whole cache).
        ``lengths`` ((B,) int, train mode) marks positions >= lengths[b] as
        right-padding: those keys are masked out of every row's softmax.
        ``cross_kv`` (whisper's decoder) is the encoder's K/V (B, F, KV, hd)
        and their positions ``arange(F)`` (int32): the queries attend over
        all F of them, non-causally, with no cache and no rope
        (:meth:`_cross`)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q = self.wq(x).reshape(b, s, h, hd)
        if cross_kv is not None:
            out = self._cross(q, *cross_kv, mode)
            return self.wo(out.reshape(b, s, h * hd))
        k = self.wk(x).reshape(b, s, kvh, hd)
        v = self.wv(x).reshape(b, s, kvh, hd)
        if mode == "decode":
            positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        else:
            positions = torch.arange(s, dtype=torch.int32, device=x.device)
        if cfg.use_rope:
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        if mode == "decode":
            out = self._decode(q, k, v, cache, layer, pos, positions, window,
                               protected)
        else:
            if mode == "prefill" and cache is not None:
                keep = min(s, cache["pos"].shape[0])
                cache_write(cache, layer, k[:, s - keep :], v[:, s - keep :], 0)
            kv_mask = None if lengths is None else positions < lengths[:, None]
            out = sdpa(
                q, k, v, positions, positions,
                window=window, causal=causal, softcap=cfg.attn_logit_softcap,
                impl=cfg.attention_impl, chunk=cfg.attn_chunk,
                protected=protected, kv_mask=kv_mask,
            )
        return self.wo(out.reshape(b, s, h * hd))

    def _cross(self, q, ek, ev, kv_pos, mode) -> Tensor:
        """Cross-attention over the encoder's keys at positions ``kv_pos``
        (the reference's ``cross_kv`` branch): window 0, not causal.
        Without a causal mask or a window the queries' positions select
        nothing, so every query sits at 0 (the reference puts a decode
        query at ``pos``, to the same effect) and decode reads
        ``kv_pos[:1]``: no tensor is built per layer or step.  Decode takes
        the decode kernel in its non-causal mode."""
        cfg = self.cfg
        if mode == "decode":
            check_decode(cfg.attention_impl, q.device, cfg.attn_logit_softcap)
            return decode_attention(q, ek, ev, kv_pos[:1], kv_pos, causal=False)
        q_pos = torch.zeros(q.shape[1], dtype=torch.int32, device=q.device)
        return sdpa(
            q, ek, ev, q_pos, kv_pos, window=0, causal=False,
            softcap=cfg.attn_logit_softcap, impl=cfg.attention_impl,
            chunk=cfg.attn_chunk,
        )

    def _decode(self, q, k, v, cache, layer, pos, positions, window,
                protected) -> Tensor:
        """``pos`` (host int) picks the cache slot; the kernel reads the
        query's position from ``positions``, the (1,) int32 tensor on the
        device that the rope already used."""
        cfg = self.cfg
        slots = cache["pos"].shape[0]
        check_decode(cfg.attention_impl, q.device, cfg.attn_logit_softcap)
        cache_write(cache, layer, k, v, cache_slot(pos, slots, protected))
        k_all, v_all = cache_kv(cache, layer, q.dtype)
        return decode_attention(
            q, k_all, v_all, positions, cache["pos"], window=window,
            protected=protected,
        )
