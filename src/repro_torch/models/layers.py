"""Common layers (port of ``repro.models.layers``).

Parameters live in ``nn.Module``s.  The reference keeps float32 parameters
and casts them to the activation dtype at every use (``x @ w.astype(
x.dtype)``).  The port casts at every use too, from the config's
``storage_dtype``: for serving (``param_dtype`` None) each weight is stored
in the dtype the reference would use it in, cast once when it is created
or loaded, which gives the same numbers; for training (``param_dtype``
float32, as in the reference) it is stored in float32 and cast at use, so
AdamW's small steps move it.  The norm scales and the time-embedding MLP,
which the reference runs in float32, are float32 either way.  Parameters
are built with ``requires_grad=False``; a trainer turns gradients on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import rownorm
from repro_torch.kernels.gemm import bgemm, gemm

Tensor = torch.Tensor


def init_tensor(
    shape: tuple[int, ...], init: str, generator: torch.Generator,
    device, dtype, scale: float = 1.0,
) -> Tensor:
    """The reference's ``P.initialize`` rules: fan_in | zeros | ones |
    normal | embed, drawn in float32 from ``generator`` then cast."""
    if init == "zeros":
        return torch.zeros(shape, device=device, dtype=dtype)
    if init == "ones":
        return torch.ones(shape, device=device, dtype=dtype)
    z = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    if init == "normal":
        w = scale * z
    elif init == "embed":
        w = z * 0.02 * scale
    elif init == "fan_in":
        fan_in = shape[0] if len(shape) >= 2 else 1
        w = z * (scale / math.sqrt(max(fan_in, 1)))
    else:
        raise ValueError(f"unknown init {init!r}")
    return w.to(dtype)


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w`` stored (d_in, d_out) like the reference
    (so weights map across without a transpose).  The product is
    :func:`~repro_torch.kernels.gemm.gemm` (on the card its row-invariant
    kernel, on the CPU its plain version); ``meta`` tensors (the dry run)
    take the plain product, whose ops the counter counts."""

    def __init__(
        self, d_in: int, d_out: int, *, bias: bool = False, init: str = "fan_in",
        generator: torch.Generator, device, dtype,
    ):
        super().__init__()
        self.w = nn.Parameter(
            init_tensor((d_in, d_out), init, generator, device, dtype),
            requires_grad=False,
        )
        self.b = (
            nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype),
                         requires_grad=False)
            if bias else None
        )

    def forward(self, x: Tensor) -> Tensor:
        w = self.w.to(x.dtype)
        b = None if self.b is None else self.b.to(x.dtype)
        if x.device.type == "meta":
            y = x @ w
            return y if b is None else y + b
        y = gemm(x.reshape(-1, x.shape[-1]), w, b)
        return y.reshape(*x.shape[:-1], w.shape[1])


def contract(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """``torch.einsum(eq, a, b)`` of two operands as one
    :func:`~repro_torch.kernels.gemm.bgemm`: the letters of both operands
    and the output are its batch, those of ``a`` and the output its rows,
    those of both operands alone its sum (K), those of ``b`` and the output
    its columns.  Each operand is permuted into that order (a copy changes
    no value), so on the card every output element is one sum in an order
    fixed by (K, N), whatever the batch (cuBLAS's ``bmm`` picked its kernel
    by the batch).  ``meta`` tensors (the dry run) take ``torch.einsum``
    itself, whose ops the counter counts."""
    if a.device.type == "meta":
        return torch.einsum(eq, a, b)
    ins, out = eq.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    batch = [c for c in sa if c in sb and c in out]
    rows = [c for c in sa if c not in sb]
    ksum = [c for c in sa if c in sb and c not in out]
    cols = [c for c in sb if c not in sa]
    if any(c not in out for c in rows + cols):
        raise ValueError(f"contract: {eq!r} sums a letter of one operand alone")
    size = dict(zip(sa, a.shape)) | dict(zip(sb, b.shape))

    def shape(letters):
        return math.prod(size[c] for c in letters)

    x = a.permute([sa.index(c) for c in batch + rows + ksum]).reshape(
        shape(batch), shape(rows), shape(ksum))
    w = b.permute([sb.index(c) for c in batch + ksum + cols]).reshape(
        shape(batch), shape(ksum), shape(cols))
    order = batch + rows + cols
    y = bgemm(x, w).reshape([size[c] for c in order])
    return y.permute([order.index(c) for c in out])


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5, *, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(d, device=device, dtype=torch.float32),
            requires_grad=False,
        )

    def forward(self, x: Tensor) -> Tensor:
        return rmsnorm(x, self.scale, self.eps)


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    """RMS norm over the last axis, statistics in float32
    (:func:`repro_torch.kernels.rownorm.rmsnorm`)."""
    return rownorm.rmsnorm(x, scale, eps)


class LayerNorm(nn.Module):
    """LayerNorm with a scale and a bias, statistics in float32 (whisper)."""

    def __init__(self, d: int, eps: float = 1e-5, *, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(d, device=device, dtype=torch.float32),
            requires_grad=False,
        )
        self.bias = nn.Parameter(
            torch.zeros(d, device=device, dtype=torch.float32),
            requires_grad=False,
        )

    def forward(self, x: Tensor) -> Tensor:
        return layernorm(x, self.scale, self.bias, self.eps)


def layernorm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last axis, statistics in float32
    (:func:`repro_torch.kernels.rownorm.layernorm`)."""
    return rownorm.layernorm(x, scale, bias, eps)


def gelu(x: Tensor) -> Tensor:
    """GELU in its tanh form, as ``jax.nn.gelu`` computes it by default."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """Gated MLP, swiglu (``act="silu"``) or geglu (``act="gelu"``), or
    the plain ``gelu(x @ wi) @ wo`` (``act="gelu_plain"``, whisper)."""

    def __init__(self, d: int, d_ff: int, act: str = "silu", *, generator,
                 device, dtype):
        super().__init__()
        if act not in ("silu", "gelu", "gelu_plain"):
            raise ValueError(f"unknown mlp_act {act!r}")
        self.act = F.silu if act == "silu" else gelu
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wg = Linear(d, d_ff, **kw) if act != "gelu_plain" else None
        self.wi = Linear(d, d_ff, **kw)
        self.wo = Linear(d_ff, d, **kw)

    def forward(self, x: Tensor) -> Tensor:
        if self.wg is None:
            return self.wo(self.act(self.wi(x)))
        return self.wo(self.act(self.wg(x)) * self.wi(x))


class CausalConv(nn.Module):
    """Depthwise causal conv parameters: ``w`` (width, d) and ``b`` (d,),
    in the compute dtype the reference casts them to."""

    def __init__(self, d: int, width: int, *, generator, device, dtype):
        super().__init__()
        self.w = nn.Parameter(
            init_tensor((width, d), "normal", generator, device, dtype, 0.1),
            requires_grad=False,
        )
        self.b = nn.Parameter(torch.zeros(d, device=device, dtype=dtype),
                              requires_grad=False)

    def forward(self, x: Tensor, state: Tensor | None = None):
        return causal_conv1d(self.w, self.b, x, state)


def causal_conv1d(w: Tensor, b: Tensor, x: Tensor, state: Tensor | None = None):
    """Depthwise causal conv over x (B, S, d) with w (W, d), in x's dtype:
    left zero pad, or the carried ``state`` (B, W-1, d).  Returns (y,
    new_state), the new state being the last W-1 inputs (the decode carry).
    The taps are summed one by one in the reference's order."""
    w = w.to(x.dtype)
    width, s = w.shape[0], x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[-1]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S + W - 1, d)
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i : i + s] * w[i]
    y = y + b.to(x.dtype)
    new_state = xp[:, xp.shape[1] - (width - 1) :] if width > 1 else pad
    return y, new_state


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_time_embed(t: Tensor, dim: int, max_period: float = 1e4) -> Tensor:
    """t: scalar or (B,) in [0, 1] -> (B?, dim) float32 embedding."""
    t = t.to(torch.float32) * 1000.0  # scale to a DDPM-like range
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    ang = t[..., None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class TimeMLP(nn.Module):
    """Sinusoidal embedding -> linear -> silu -> linear, in float32."""

    def __init__(self, d_model: int, d_time: int = 256, *, generator, device):
        super().__init__()
        self.d_time = d_time
        kw = dict(bias=True, generator=generator, device=device,
                  dtype=torch.float32)
        self.w1 = Linear(d_time, d_model, **kw)
        self.w2 = Linear(d_model, d_model, **kw)

    def forward(self, t: Tensor) -> Tensor:
        h = sinusoidal_time_embed(t, self.d_time)
        return self.w2(F.silu(self.w1(h)))
