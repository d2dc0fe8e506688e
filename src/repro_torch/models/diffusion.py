"""Diffusion-LM wrapper: the block stack as an eps-prediction denoiser
(port of ``repro.models.diffusion``).

x_t lives in embedding space (B, S, d).  The wrapper adds sinusoidal time
conditioning, runs the block stack non-causally and projects to a noise
estimate; each NFE of an ERA run is one :meth:`DiffusionLM.eps`.  Every
stack of the reference is ported: dense (also paligemma-3b's Gemma
decoder), MoE (mixtral), MLA + MoE (deepseek-v2-lite), xLSTM (xlstm-350m),
hymba (hymba-1.5b) and whisper-base's ``xdec`` decoder.  MLA attends
causally whatever ``causal`` says, as the reference's does, so a
deepseek-v2-lite denoiser is causal (``models/mla.py``); so does ``xdec``'s
self-attention, so a whisper denoiser is causal too, and it runs
decoder-only (no encoder states, no cross-attention).  The scans (Mamba,
mLSTM, sLSTM) always run left to right, while hymba's attention half
denoises bidirectionally.  As in the reference, the denoiser runs no
prefix (meta tokens, patches) and protects no slot.

The module owns its weights.  It is built on the card unless the caller
passes ``device="cpu"``, with the reference's init rules drawn from a
seeded ``torch.Generator`` (``eps_head`` starts at zero, as in the
reference).  Reference weights map in through
:func:`repro_torch.interop.params_from_jax` and ``load_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import layers as L
from repro_torch.models.model import Backbone

Tensor = torch.Tensor

#: block kinds safe to run right-padded with per-row ``lengths`` (every
#: cross-position mixing is an attention softmax that takes the kv mask, or
#: a left-to-right scan).  The reference's full set.  The MoE FFN does not
#: hold this up to the reference's claim: its capacity comes from the
#: padded length, so padding can change which assignments it drops
#: (``models/moe.py``, ROADMAP queue 3).
MASKABLE_BLOCKS = frozenset(
    {
        "dense", "moe", "enc", "xdec",
        "mlstm", "slstm", "hymba_swa", "hymba_full",
        "mla_moe",
    }
)


class DiffusionLM(nn.Module):
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        device: str | torch.device | None = None,
        seed: int = 0,
        causal: bool = False,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        d = cfg.d_model
        self.config = cfg
        self.causal = causal  # attention families denoise bidirectionally
        self.backbone = Backbone(cfg, generator=gen, device=dev)
        self.time_mlp = L.TimeMLP(d, generator=gen, device=dev)
        self.in_proj = L.Linear(d, d, generator=gen, device=dev,
                                dtype=cfg.storage_dtype)
        self.eps_head = L.Linear(
            d, d, bias=True, init="zeros", generator=gen, device=dev,
            dtype=cfg.storage_dtype,
        )

    @property
    def device(self) -> torch.device:
        return self.in_proj.w.device

    @property
    def supports_length_masking(self) -> bool:
        """True iff every block kind is in :data:`MASKABLE_BLOCKS`."""
        return all(kind in MASKABLE_BLOCKS for kind, _ in self.config.blocks)

    @torch.no_grad()
    def eps(
        self, x_t: Tensor, t, lengths: Tensor | None = None
    ) -> Tensor:
        """Noise prediction eps_theta(x_t, t).  x_t: (B, S, d); t a scalar
        shared by the batch, or per-row times (B,).  Returns
        ``eps + x_t`` in x_t's dtype, computed in float32.  ``lengths``
        ((B,) int) masks pad keys out of every softmax and zeroes eps at
        pad positions, so a padded row's tail stays inert."""
        return self.eps_grad(x_t, t, lengths)

    def eps_grad(
        self, x_t: Tensor, t, lengths: Tensor | None = None
    ) -> Tensor:
        """:meth:`eps` under autograd (no ``no_grad``), for training."""
        cfg = self.config
        t = torch.as_tensor(t, dtype=torch.float32, device=x_t.device)
        tcond = self.time_mlp(t.reshape(-1))                   # (1|B, d)
        h = self.in_proj(x_t.to(cfg.dtype))
        h = h + tcond[:, None, :].to(h.dtype)
        h = self.backbone(h, causal=self.causal, lengths=lengths)
        eps = self.eps_head(h)
        out = (eps.to(torch.float32) + x_t.to(torch.float32)).to(x_t.dtype)
        if lengths is not None:
            valid = (
                torch.arange(out.shape[1], device=out.device)
                < lengths[:, None]
            )
            out = torch.where(valid[..., None], out, out.new_zeros(()))
        return out

    def eps_fn(self, lengths: Tensor | None = None):
        """Closure matching the solver API: ``eps_fn(x, t) -> eps``."""
        return lambda x, t: self.eps(x, t, lengths=lengths)

    def loss_at(self, x0: Tensor, u0, noise: Tensor, schedule) -> tuple[Tensor, dict]:
        """The reference's eps-matching loss (Eq. 5 of the paper) on clean
        latents ``x0`` (B, S, d), given its draws: ``u0`` in [0, 1) (a
        0-d tensor) and ``noise`` (B, S, d).  Times are low-discrepancy
        across the batch, ``u = (u0 + arange(B) / B) % 1`` and ``t = t_end
        + (t_begin - t_end) u``; ``x_t = alpha(t) x0 + sigma(t) noise`` in
        float32, denoised at its row's own ``t`` in the compute dtype.
        Returns (mse, {"diffusion_mse": mse})."""
        x0 = x0.to(torch.float32)
        b = x0.shape[0]
        u0 = torch.as_tensor(u0, dtype=torch.float32, device=x0.device)
        u = torch.remainder(
            u0 + torch.arange(b, device=x0.device, dtype=torch.float32) / b, 1.0)
        t = schedule.t_end + (schedule.t_begin - schedule.t_end) * u
        a = schedule.alpha(t)[:, None, None]
        s = schedule.sigma(t)[:, None, None]
        x_t = a * x0 + s * noise
        pred = self.eps_grad(x_t.to(self.config.dtype), t)
        mse = torch.mean((pred.to(torch.float32) - noise) ** 2)
        return mse, {"diffusion_mse": mse}

    def loss(self, batch: dict, generator: torch.Generator,
             schedule) -> tuple[Tensor, dict]:
        """:meth:`loss_at` on ``batch["latents"]``, with ``u0`` and the
        noise drawn from ``generator`` (the reference draws them from a
        ``jax.random`` key, which a torch generator cannot reproduce)."""
        x0 = batch["latents"].to(torch.float32)
        u0 = torch.rand((), generator=generator, device=x0.device)
        noise = torch.randn(x0.shape, generator=generator, device=x0.device)
        return self.loss_at(x0, u0, noise, schedule)
