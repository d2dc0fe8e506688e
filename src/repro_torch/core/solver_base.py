"""Common solver machinery (port of ``repro.core.solver_base``).

A solver turns a noise-prediction network ``eps_fn(x, t) -> eps`` plus a
:class:`NoiseSchedule` and a time grid into a sampling loop.  The reference
runs that loop as one ``lax.scan``; the port runs it as a host loop over
steps whose tensors all stay on the device.  The fixed-capacity history
buffers are allocated up front and updated in place (JAX returns updated
copies; in-place appends keep one buffer alive for the whole run).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.schedules import NoiseSchedule, timesteps

Tensor = torch.Tensor
EpsFn = Callable[[Tensor, Tensor], Tensor]


class SolverOutput(NamedTuple):
    """Result of a sampling run."""

    x0: Tensor                # final sample (at t_N)
    nfe: int                  # number of network evaluations used
    aux: dict[str, Any]       # solver-specific diagnostics


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Options shared by all solvers."""

    nfe: int = 10                        # network-evaluation budget
    scheme: str = "uniform"              # timestep scheme
    t_end: float | None = None           # override schedule.t_end
    solver_dtype: Any = torch.float32    # dtype of solver state / buffers
    return_trajectory: bool = False      # record x at every step


def ddim_step(
    schedule: NoiseSchedule, x: Tensor, eps: Tensor, t_cur, t_next
) -> Tensor:
    """Diffusion-ODE / deterministic DDIM update (paper Eq. 8), in x's
    dtype (f32 coefficients must not promote a lower-precision state)."""
    cx, ce = schedule.ddim_coeffs(t_cur, t_next)
    return cx.to(x.dtype) * x + ce.to(x.dtype) * eps.to(x.dtype)


def buffer_init(
    x_like: Tensor, capacity: int, dtype
) -> tuple[Tensor, Tensor]:
    """Fixed-capacity noise/time buffers (the paper's Lagrange buffer),
    on ``x_like``'s device."""
    eps_buf = torch.zeros(
        (capacity,) + tuple(x_like.shape), dtype=dtype, device=x_like.device
    )
    t_buf = torch.zeros((capacity,), dtype=torch.float32, device=x_like.device)
    return eps_buf, t_buf


def buffer_append(
    eps_buf: Tensor, t_buf: Tensor, idx: int, eps: Tensor, t
) -> None:
    """Write entry ``idx`` in place.  A host float ``t`` is filled in by
    the kernel (an item assignment would copy it from the host, which a
    CUDA graph cannot capture); a tensor is copied on its device."""
    eps_buf[idx] = eps.to(eps_buf.dtype)
    if isinstance(t, Tensor):
        t_buf[idx] = t
    else:
        t_buf[idx].fill_(t)


def step_grid(ts: Tensor) -> tuple[range, Tensor, Tensor]:
    """``(i, t_cur, t_next)`` for an n-step loop over the (n+1,) grid."""
    n = ts.shape[0] - 1
    return range(n), ts[:-1], ts[1:]


def loop_grid(
    ts: Tensor | None, schedule: NoiseSchedule, n: int, scheme: str,
    t_end: float | None, device: torch.device,
) -> Tensor:
    """The ``(n + 1,)`` grid an unmasked loop steps through: ``ts`` as
    given (the executor's copy on the device, so a captured loop makes no
    host-to-device copy), else built from the schedule on ``device``."""
    if ts is None:
        ts = timesteps(schedule, n, scheme, t_end=t_end, device=device)
    if tuple(ts.shape) != (n + 1,):
        raise ValueError(f"time grid shape {tuple(ts.shape)} != {(n + 1,)}")
    return ts
