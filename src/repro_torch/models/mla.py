"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434) — port of
``repro.models.mla``.

K/V are compressed into a low-rank latent ``c_kv`` (``kv_lora_rank``) plus
one rope key head shared by every head; the cache keeps only those,
``kv_lora_rank + qk_rope_head_dim`` numbers a token.

* Train and prefill expand ``c_kv`` to per-head keys and values with
  ``wkv_b`` and attend through :func:`repro_torch.models.attention.sdpa`:
  on the card the flash kernel's (192, 128) instance (q/k of 128 "nope" +
  64 rope dims, v of 128; the reference pads v to the q/k head dim and
  slices the output back, the same function), on the CPU the reference's
  naive / chunked rule.  As in the reference the attention is always
  causal, whatever the caller asks: a denoiser built on MLA is causal
  (ROADMAP queue 3).  ``lengths`` masks pad keys out of every row.
* Decode is the absorbed form in plain PyTorch, as the reference runs it
  (no Pallas kernel there): ``W_kb`` folded into the query and ``W_vb``
  into the output, so one token attends in latent space over the cache;
  slots are masked only by ``pos >= 0``.

The cache is one dict per model: ``ckv`` (L, B, slots, kv_lora_rank),
``krope`` (L, B, slots, qk_rope_head_dim) and one ``pos`` (slots,) int32,
recorded by :func:`repro_torch.models.attention.cache_fill` /
``cache_insert`` as for the K/V cache (a prefill longer than the cache
keeps its last ``slots`` entries from slot 0, as the reference does).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L

Tensor = torch.Tensor


def init_cache(cfg, num_layers: int, batch: int, slots: int, dtype,
               device) -> dict:
    """An empty latent cache: zeros and every slot position -1."""
    a = cfg.mla
    return {
        "ckv": torch.zeros((num_layers, batch, slots, a.kv_lora_rank),
                           dtype=dtype, device=device),
        "krope": torch.zeros((num_layers, batch, slots, a.qk_rope_head_dim),
                             dtype=dtype, device=device),
        "pos": torch.full((slots,), -1, dtype=torch.int32, device=device),
    }


def cache_write(cache: dict, layer: int, ckv: Tensor, krope: Tensor,
                slot: int) -> None:
    """Write ``ckv`` (B, n, r) and ``krope`` (B, n, rope) of ``layer`` at
    slots ``slot .. slot + n``, in place."""
    n = ckv.shape[1]
    cache["ckv"][layer, :, slot : slot + n] = ckv
    cache["krope"][layer, :, slot : slot + n] = krope


class MLA(nn.Module):
    """``wq``, ``wkv_a``, ``ckv_norm`` (float32 scale), ``wkv_b``, ``wo``."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        a = cfg.mla
        d, h = cfg.d_model, cfg.num_heads
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.cfg = cfg
        self.wq = L.Linear(d, h * (a.qk_nope_head_dim + a.qk_rope_head_dim), **kw)
        self.wkv_a = L.Linear(d, a.kv_lora_rank + a.qk_rope_head_dim, **kw)
        self.ckv_norm = L.RMSNorm(a.kv_lora_rank, cfg.norm_eps, device=device)
        self.wkv_b = L.Linear(
            a.kv_lora_rank, h * (a.qk_nope_head_dim + a.v_head_dim), **kw)
        self.wo = L.Linear(h * a.v_head_dim, d, **kw)

    def _project_q(self, x: Tensor, positions: Tensor):
        a, cfg = self.cfg.mla, self.cfg
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, cfg.num_heads, -1)
        q_nope, q_rope = torch.split(
            q, [a.qk_nope_head_dim, a.qk_rope_head_dim], dim=-1)
        return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)

    def _compress_kv(self, x: Tensor, positions: Tensor):
        a, cfg = self.cfg.mla, self.cfg
        c_kv, k_rope = torch.split(
            self.wkv_a(x), [a.kv_lora_rank, a.qk_rope_head_dim], dim=-1)
        c_kv = self.ckv_norm(c_kv)
        k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
        return c_kv, k_rope[:, :, 0, :]          # (B, S, r), (B, S, rope)

    def forward(
        self, x: Tensor, *, mode: str = "train", cache: dict | None = None,
        layer: int = 0, pos: int | None = None,
        lengths: Tensor | None = None,
    ) -> Tensor:
        """``mode``: ``train`` (the full sequence), ``prefill`` (also fills
        ``layer`` of the latent ``cache``) or ``decode`` (one token at the
        host-int position ``pos``, whose slot the caller has recorded with
        :func:`repro_torch.models.attention.cache_insert`)."""
        if mode == "decode":
            return self._decode(x, cache, layer, pos)
        a, cfg = self.cfg.mla, self.cfg
        b, s, _ = x.shape
        h = cfg.num_heads
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        kv_mask = None if lengths is None else positions < lengths[:, None]
        q_nope, q_rope = self._project_q(x, positions)
        c_kv, k_rope = self._compress_kv(x, positions)
        k_nope, v = torch.split(
            self.wkv_b(c_kv).reshape(b, s, h, -1),
            [a.qk_nope_head_dim, a.v_head_dim], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(b, s, h, a.qk_rope_head_dim)],
            dim=-1)
        # always causal, like the reference; CPU tensors take its naive /
        # chunked size rule (impl "auto"), CUDA tensors the flash kernel
        out = A.sdpa(q, k, v.contiguous(), positions, positions, window=0,
                     causal=True, softcap=0.0, impl="auto",
                     chunk=cfg.attn_chunk, kv_mask=kv_mask)
        if mode == "prefill" and cache is not None:
            keep = min(s, cache["pos"].shape[0])
            cache_write(cache, layer, c_kv[:, s - keep :], k_rope[:, s - keep :], 0)
        return self.wo(out.reshape(b, s, h * a.v_head_dim))

    def _decode(self, x: Tensor, cache: dict, layer: int, pos: int) -> Tensor:
        """Absorbed-form decode of one token against the latent cache."""
        a, cfg = self.cfg.mla, self.cfg
        b, s, _ = x.shape                         # s == 1
        h = cfg.num_heads
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q_nope, q_rope = self._project_q(x, positions)           # (B, 1, H, *)
        c_kv, k_rope = self._compress_kv(x, positions)
        cache_write(cache, layer, c_kv, k_rope,
                    A.cache_slot(pos, cache["pos"].shape[0]))
        w = self.wkv_b.w.reshape(
            a.kv_lora_rank, h, a.qk_nope_head_dim + a.v_head_dim)
        w_kb = w[..., : a.qk_nope_head_dim]                      # (r, H, nope)
        w_vb = w[..., a.qk_nope_head_dim :]                      # (r, H, v)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_kb.to(q_nope.dtype))
        ckv, krope = cache["ckv"][layer], cache["krope"][layer]  # (B, T, *)
        scale = (a.qk_nope_head_dim + a.qk_rope_head_dim) ** -0.5
        scores = (
            torch.einsum("bshr,btr->bhst", q_lat, ckv.to(q_lat.dtype))
            + torch.einsum("bshr,btr->bhst", q_rope, krope.to(q_rope.dtype))
        ).to(torch.float32) * scale
        valid = cache["pos"] >= 0
        scores = torch.where(valid, scores,
                             torch.full((), A.NEG_INF, device=x.device))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", probs.to(ckv.dtype), ckv)
        out = torch.einsum("bshr,rhv->bshv", ctx, w_vb.to(ctx.dtype))
        return self.wo(out.reshape(b, s, h * a.v_head_dim))
