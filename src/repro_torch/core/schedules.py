"""Noise schedules and timestep schemes (port of ``repro.core.schedules``).

Continuous-time VP diffusion, ``x_t = alpha(t) x_0 + sigma(t) eps`` with
``alpha^2 + sigma^2 = 1`` and ``t`` running from ``t_begin`` (~1, noise)
down to ``t_end`` (~0, data).  Every function works on float32 tensors on
whatever device they live on; :func:`timesteps` builds the grid on the CPU
with the reference's float32 arithmetic and moves it to ``device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor


def _f32(t) -> Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Continuous-time VP noise schedule; ``log_alpha_bar_fn`` maps t in
    [0, 1] to ``log(alpha_bar(t))``.  Everything else is derived."""

    name: str
    log_alpha_bar_fn: Callable[[Tensor], Tensor]
    t_begin: float = 1.0
    t_end: float = 1e-3
    num_train_steps: int = 1000

    def log_alpha_bar(self, t) -> Tensor:
        return self.log_alpha_bar_fn(t)

    def alpha(self, t) -> Tensor:
        return torch.exp(0.5 * self.log_alpha_bar(t))

    def sigma(self, t) -> Tensor:
        return torch.sqrt(-torch.expm1(self.log_alpha_bar(t)))

    def lam(self, t) -> Tensor:
        """Half log-SNR: lambda(t) = log(alpha(t) / sigma(t))."""
        log_ab = self.log_alpha_bar(t)
        return 0.5 * (log_ab - torch.log(-torch.expm1(log_ab)))

    def inv_lam(self, lam: Tensor) -> Tensor:
        """Invert lambda(t) by bisection (schedules may override)."""
        lo = torch.zeros_like(lam)
        hi = torch.ones_like(lam)
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            go_right = self.lam(mid) > lam  # lambda decreases in t
            lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
        return 0.5 * (lo + hi)

    def ddim_coeffs(self, t_cur, t_next) -> tuple[Tensor, Tensor]:
        """(cx, ce) such that x_next = cx * x_cur + ce * eps (paper Eq. 8)."""
        a_cur, a_next = self.alpha(t_cur), self.alpha(t_next)
        s_cur, s_next = self.sigma(t_cur), self.sigma(t_next)
        cx = a_next / a_cur
        ce = s_next - cx * s_cur
        return cx, ce


def linear_schedule(
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
    num_train_steps: int = 1000,
    t_end: float = 1e-3,
) -> NoiseSchedule:
    """Continuous interpolation of the DDPM linear-beta schedule:
    log alpha_bar(t) = -0.25 t^2 (b1 - b0) - 0.5 t b0, betas scaled by T."""
    b0 = beta_start * num_train_steps
    b1 = beta_end * num_train_steps

    def log_alpha_bar(t):
        t = _f32(t)
        return -0.25 * t**2 * (b1 - b0) - 0.5 * t * b0

    sched = NoiseSchedule(
        name="linear",
        log_alpha_bar_fn=log_alpha_bar,
        t_end=t_end,
        num_train_steps=num_train_steps,
    )

    # closed-form inverse lambda: t solves 0.25 (b1-b0) t^2 + 0.5 b0 t
    # + log_ab = 0 with log_ab = -softplus(-2 lam)
    def inv_lam_exact(lam):
        x = -2.0 * lam
        log_ab = -torch.logaddexp(x, torch.zeros_like(x))
        a = 0.25 * (b1 - b0)
        b = 0.5 * b0
        return (-b + torch.sqrt(b * b - 4 * a * log_ab)) / (2 * a)

    object.__setattr__(sched, "inv_lam", inv_lam_exact)
    return sched


def cosine_schedule(s: float = 8e-3, t_end: float = 1e-3) -> NoiseSchedule:
    """Improved-DDPM cosine schedule, continuous form."""
    log_f0 = 2.0 * math.log(math.cos(s / (1 + s) * math.pi / 2))

    def log_alpha_bar(t):
        t = _f32(t)
        f = torch.cos((t + s) / (1 + s) * math.pi / 2)
        return 2.0 * torch.log(torch.clamp(f, min=1e-6)) - log_f0

    return NoiseSchedule(
        name="cosine", log_alpha_bar_fn=log_alpha_bar, t_end=t_end
    )


def get_schedule(name: str, **kw) -> NoiseSchedule:
    if name == "linear":
        return linear_schedule(**kw)
    if name == "cosine":
        return cosine_schedule(**kw)
    raise ValueError(f"unknown schedule {name!r}")


def _linspace(start, stop, num: int) -> Tensor:
    """float32 ``start + i * (stop - start) / (num - 1)`` with the last
    point pinned to ``stop`` — the reference's ``jnp.linspace`` arithmetic."""
    start, stop = _f32(start), _f32(stop)
    delta = (stop - start) / (num - 1)
    out = start + torch.arange(num, dtype=torch.float32) * delta
    out[-1] = stop
    return out


def timesteps(
    schedule: NoiseSchedule,
    num_steps: int,
    scheme: str = "uniform",
    t_begin: float | None = None,
    t_end: float | None = None,
    device: str | torch.device = "cpu",
) -> Tensor:
    """(num_steps + 1,) decreasing float32 times from t_begin to t_end.

    The grid is computed on the CPU, so every device steps through the
    same floats, then moved to ``device``."""
    t0 = schedule.t_begin if t_begin is None else t_begin
    t1 = schedule.t_end if t_end is None else t_end
    if scheme == "uniform":
        ts = _linspace(t0, t1, num_steps + 1)
    elif scheme == "quadratic":
        ts = _linspace(math.sqrt(t0), math.sqrt(t1), num_steps + 1) ** 2
    elif scheme == "logsnr":
        lam0 = schedule.lam(_f32(t0))
        lam1 = schedule.lam(_f32(t1))
        ts = schedule.inv_lam(_linspace(lam0, lam1, num_steps + 1))
        ts[0], ts[-1] = t0, t1  # pin the endpoints exactly
    else:
        raise ValueError(f"unknown timestep scheme {scheme!r}")
    return ts.to(device)
