"""GQA attention for the denoising (train-mode) path — port of
``repro.models.attention``.

Three SDPA implementations, chosen by ``impl``:

* ``naive``   — materializes (Sq, Sk) scores (the reference's
  ``_naive_sdpa``, same dtype behaviour);
* ``chunked`` — streaming softmax over KV chunks (``_chunked_sdpa``);
* ``flash``   — :func:`repro_torch.kernels.flash_attention.flash_attention`,
  the hand-written kernel on the card.

CUDA tensors always take ``flash`` (``auto`` or ``flash``; naming a plain
version for them raises).  For CPU tensors ``auto`` picks naive or chunked
by the reference's size rule.  Masking is positional (every key
carries an absolute position) plus an optional per-row ``kv_mask``.  The
sliding-window banded path and the KV cache wait for a later slice: the
dense architectures ported so far have no sliding window.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
    return out.reshape(b, sq, h, hd)


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
    acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32, device=q.device)
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
    return out.reshape(b, sq, h, hd).to(q.dtype)


def resolve_impl(impl: str, device: torch.device, sq: int, sk: int) -> str:
    if device.type == "cuda":
        if impl not in ("auto", "flash"):
            raise ValueError(
                f"attention impl {impl!r} is a plain version for CPU tensors; "
                f"CUDA tensors take the flash kernel"
            )
        return "flash"
    if impl != "auto":
        return impl
    return "naive" if sq * sk <= 1024 * 2048 else "chunked"


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
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); ``kv_mask`` an optional
    (B, Sk) per-row key-validity mask (right-padded mixed-length rows)."""
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


class Attention(nn.Module):
    """Projections + rope + SDPA, train mode (full-sequence layout)."""

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
        self, x: Tensor, *, window: int = 0, causal: bool = True,
        protected: int = 0, lengths: Tensor | None = None,
    ) -> Tensor:
        """``lengths`` ((B,) int) marks positions >= lengths[b] as
        right-padding: those keys are masked out of every row's softmax."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q = self.wq(x).reshape(b, s, h, hd)
        k = self.wk(x).reshape(b, s, kvh, hd)
        v = self.wv(x).reshape(b, s, kvh, hd)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        if cfg.use_rope:
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        kv_mask = None if lengths is None else positions < lengths[:, None]
        out = sdpa(
            q, k, v, positions, positions,
            window=window, causal=causal, softcap=cfg.attn_logit_softcap,
            impl=cfg.attention_impl, chunk=cfg.attn_chunk,
            protected=protected, kv_mask=kv_mask,
        )
        return self.wo(out.reshape(b, s, h * hd))
