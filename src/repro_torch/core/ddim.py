"""DDIM sampler (Song et al. 2020a), the order-1 diffusion-ODE baseline
(port of ``repro.core.ddim``).

Deterministic (eta = 0) DDIM is Euler on the diffusion ODE in the
(alpha, sigma) parameterization, the paper's Eq. 8; one NFE per step.  The
loop keeps no history, so the program allocates no buffers.  It is a host
loop over steps whose tensors stay on the device and makes no
host-to-device copy once its grid is there (``ts``, or ``steps.ts`` under
step masking), so the executor captures a whole run as one CUDA graph.
"""

from __future__ import annotations

import torch

from repro_torch.core.program import (
    SolverProgram,
    StepMask,
    step_active,
    step_row_times,
    trajectory_aux,
)
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.core.solver_base import (
    EpsFn,
    SolverConfig,
    SolverOutput,
    ddim_step,
    loop_grid,
)

Tensor = torch.Tensor


def sample_scan(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: SolverConfig,
    steps: StepMask | None = None,
    ts: Tensor | None = None,
) -> SolverOutput:
    """``config.nfe`` DDIM steps.  ``steps`` gives each row its own grid
    and freezes a spent row bitwise; ``ts`` is the ``(nfe + 1,)`` grid on
    ``x_init``'s device when no ``steps`` are given (None builds it)."""
    n = config.nfe
    if steps is None:
        ts = loop_grid(ts, schedule, n, config.scheme, config.t_end,
                       x_init.device)
    x = x_init
    traj = []
    for i in range(n):
        if steps is None:
            t_cur, t_next = ts[i], ts[i + 1]
        else:
            t_cur, t_next = step_row_times(steps, i, x.dim())
        x_next = ddim_step(schedule, x, eps_fn(x, t_cur), t_cur, t_next)
        if steps is not None:
            x_next = torch.where(step_active(steps, i, x.dim()), x_next, x)
        if config.return_trajectory:
            traj.append(x_next)
        x = x_next
    aux = trajectory_aux(x_init, traj, config.return_trajectory)
    return SolverOutput(x0=x, nfe=n, aux=aux)


def sample(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: SolverConfig,
    device: str | torch.device | None = None,
) -> SolverOutput:
    """Self-contained entry on ``device`` (the card unless the caller
    passes ``"cpu"``)."""
    return DDIMProgram().sample(eps_fn, x_init, schedule, config,
                                device=device)


class DDIMProgram(SolverProgram):
    """DDIM's update is elementwise over positions, so a right-padded batch
    needs no solver-side masking (``lengths`` is the denoiser's concern)."""

    name = "ddim"

    def supports_steps(self, cfg: SolverConfig) -> bool:
        return True

    def sample_scan(
        self, eps_fn, x_init, buffers, schedule, cfg, lengths=None,
        steps=None, ts=None,
    ):
        return sample_scan(eps_fn, x_init, schedule, cfg, steps=steps, ts=ts)
