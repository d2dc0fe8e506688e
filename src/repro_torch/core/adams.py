"""Adams-family baselines the paper compares against (port of
``repro.core.adams``).

* ``explicit_adams``: Adams--Bashforth order 4 in eps-space with an
  increasing-order warm-up, the linear multistep scheme under PNDM/FON
  (paper Eq. 9); 1 NFE per step.
* ``implicit_adams_pece``: the traditional predictor-corrector for
  implicit Adams (Diethelm et al. 2002): AB4 predictor, evaluate at the
  predicted point, AM4 corrector, evaluate at the corrected point (stored
  as history); 2 NFE per step.

Both loops run on fixed-capacity eps/t history buffers updated in place,
as ERA's do.  The reference's ``lax.switch`` on the warm-up order and its
``lax.cond`` on the last step are Python branches on the step index.  The
loops make no host-to-device copy once their grid is on the device, so
the executor captures each run as one CUDA graph.  Under a
:class:`~repro_torch.core.program.StepMask` each row steps through its own
grid, a spent row freezes bitwise, and the history entry after a row's own
last step is zero, as in the reference; ``t_buf`` then holds 0.0 (nothing
reads it: the Adams coefficients are fixed).
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
    buffer_append,
    buffer_init,
    ddim_step,
    loop_grid,
)

Tensor = torch.Tensor

# Adams--Bashforth coefficients by order, applied to (e_i, e_{i-1}, ...).
AB_COEFFS = {
    1: (1.0,),
    2: (3 / 2, -1 / 2),
    3: (23 / 12, -16 / 12, 5 / 12),
    4: (55 / 24, -59 / 24, 37 / 24, -9 / 24),  # paper Eq. 9
}
AM4 = (9 / 24, 19 / 24, -5 / 24, 1 / 24)       # paper Eq. 10/11


def _ab_predict(eps_buf: Tensor, i: int, order: int) -> Tensor:
    """AB combination of the last stored noises at the best order available
    at step i (the warm-up ramps the order up instead of spending NFE)."""
    out = None
    for j, c in enumerate(AB_COEFFS[min(i + 1, order)]):
        out = c * eps_buf[i - j] if out is None else out + c * eps_buf[i - j]
    return out


def alloc_buffers(
    x: Tensor, config: SolverConfig, num_steps: int | None = None
) -> tuple[Tensor, Tensor]:
    """Fresh eps/t history buffers for an Adams run (``num_steps`` defaults
    to ``config.nfe``; PECE passes its halved step count)."""
    cap = (config.nfe if num_steps is None else num_steps) + 1
    return buffer_init(x, cap, config.solver_dtype)


def _start(
    eps_fn: EpsFn, x_init: Tensor, eps_buf: Tensor, t_buf: Tensor,
    schedule: NoiseSchedule, config: SolverConfig, n: int,
    steps: StepMask | None, ts: Tensor | None,
) -> tuple[Tensor, Tensor | None]:
    """Check the buffers, evaluate the network at the start point into
    entry 0, and return the latents in the solver dtype and the grid."""
    if tuple(eps_buf.shape) != (n + 1,) + tuple(x_init.shape):
        raise ValueError(
            f"eps buffer shape {tuple(eps_buf.shape)} != "
            f"{(n + 1,) + tuple(x_init.shape)}"
        )
    if steps is None:
        ts = loop_grid(ts, schedule, n, config.scheme, config.t_end,
                       x_init.device)
        t0 = ts[0]
    else:
        t0 = steps.ts[:, 0].reshape((-1,) + (1,) * (x_init.dim() - 1))
    x = x_init.to(config.solver_dtype)
    buffer_append(eps_buf, t_buf, 0, eps_fn(x, t0),
                  0.0 if steps is not None else t0)
    return x, ts


def _observe(
    eps_fn: EpsFn, x: Tensor, t, i: int, steps: StepMask | None, dt
) -> Tensor:
    """The noise at the point step i reached, kept as history entry i + 1;
    zero for a row whose own steps end at step i."""
    e = eps_fn(x, t).to(dt)
    if steps is not None:
        e = torch.where(step_active(steps, i + 1, x.dim()), e, e.new_zeros(()))
    return e


def explicit_adams_scan(
    eps_fn: EpsFn,
    x_init: Tensor,
    eps_buf: Tensor,     # (nfe+1, *x.shape), updated in place
    t_buf: Tensor,       # (nfe+1,), updated in place
    schedule: NoiseSchedule,
    config: SolverConfig,
    order: int = 4,
    steps: StepMask | None = None,
    ts: Tensor | None = None,
) -> SolverOutput:
    """AB-``order`` linear multistep in eps-space (PNDM-style), 1 NFE per
    step.  The last step's noise is never evaluated, so the reference's
    zero entry there is not written (nothing reads it)."""
    n = config.nfe
    dt = config.solver_dtype
    x, ts = _start(eps_fn, x_init, eps_buf, t_buf, schedule, config, n,
                   steps, ts)
    traj = []
    for i in range(n):
        if steps is None:
            t_cur, t_next = ts[i], ts[i + 1]
        else:
            t_cur, t_next = step_row_times(steps, i, x.dim())
        x_next = ddim_step(schedule, x, _ab_predict(eps_buf, i, order),
                           t_cur, t_next)
        if steps is not None:
            x_next = torch.where(step_active(steps, i, x.dim()), x_next, x)
        if i + 1 < n:
            buffer_append(eps_buf, t_buf, i + 1,
                          _observe(eps_fn, x_next, t_next, i, steps, dt),
                          0.0 if steps is not None else t_next)
        if config.return_trajectory:
            traj.append(x_next)
        x = x_next
    aux = trajectory_aux(x_init, traj, config.return_trajectory, dtype=dt)
    return SolverOutput(x0=x.to(x_init.dtype), nfe=n, aux=aux)


def explicit_adams_sample(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: SolverConfig,
    device: str | torch.device | None = None,
) -> SolverOutput:
    """Self-contained AB4 entry on ``device`` (the card unless the caller
    passes ``"cpu"``)."""
    return ExplicitAdamsProgram().sample(eps_fn, x_init, schedule, config,
                                         device=device)


def pece_num_steps(nfe: int) -> int:
    """PECE spends 2 NFE per step: budget B buys B // 2 steps."""
    return max(nfe // 2, 1)


def implicit_adams_pece_scan(
    eps_fn: EpsFn,
    x_init: Tensor,
    eps_buf: Tensor,     # (n_steps+1, *x.shape), updated in place
    t_buf: Tensor,       # (n_steps+1,), updated in place
    schedule: NoiseSchedule,
    config: SolverConfig,
    steps: StepMask | None = None,
    ts: Tensor | None = None,
) -> SolverOutput:
    """Traditional PECE implicit Adams, 2 NFE per step: a budget B takes
    B // 2 steps; the history holds evaluations at corrected points.
    ``steps.active_steps`` counts PECE steps, not NFE.

    ``nfe`` reports the evaluations made: one at the start, one at each
    predicted point and one at each corrected point but the last, so
    ``2 * n_steps``.  The reference reports ``2 * n_steps - 1``."""
    n = pece_num_steps(config.nfe)
    dt = config.solver_dtype
    x, ts = _start(eps_fn, x_init, eps_buf, t_buf, schedule, config, n,
                   steps, ts)
    c0, c1, c2, c3 = AM4
    traj = []
    for i in range(n):
        if steps is None:
            t_cur, t_next = ts[i], ts[i + 1]
        else:
            t_cur, t_next = step_row_times(steps, i, x.dim())
        # P: AB predictor at the best order available; E at its point
        x_pred = ddim_step(schedule, x, _ab_predict(eps_buf, i, 4),
                           t_cur, t_next)
        e_bar = eps_fn(x_pred, t_next).to(dt)
        # C: AM4 corrector, the trapezoid rule while history is short
        e_i = eps_buf[i]
        if i >= 2:
            eps_c = c0 * e_bar + c1 * e_i + c2 * eps_buf[i - 1] + c3 * eps_buf[i - 2]
        else:
            eps_c = 0.5 * (e_bar + e_i)
        x_next = ddim_step(schedule, x, eps_c, t_cur, t_next)
        if steps is not None:
            x_next = torch.where(step_active(steps, i, x.dim()), x_next, x)
        # E at the corrected point, for the history (not after the last step)
        if i + 1 < n:
            buffer_append(eps_buf, t_buf, i + 1,
                          _observe(eps_fn, x_next, t_next, i, steps, dt),
                          0.0 if steps is not None else t_next)
        if config.return_trajectory:
            traj.append(x_next)
        x = x_next
    aux = trajectory_aux(x_init, traj, config.return_trajectory, dtype=dt)
    return SolverOutput(x0=x.to(x_init.dtype), nfe=2 * n, aux=aux)


def implicit_adams_pece_sample(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: SolverConfig,
    device: str | torch.device | None = None,
) -> SolverOutput:
    """Self-contained PECE entry on ``device`` (the card unless the caller
    passes ``"cpu"``)."""
    return ImplicitAdamsPECEProgram().sample(eps_fn, x_init, schedule, config,
                                             device=device)


class ExplicitAdamsProgram(SolverProgram):
    """AB4's combine is elementwise over positions: no solver-side sequence
    reduction to mask under ``lengths``."""

    name = "explicit_adams"

    def supports_steps(self, cfg: SolverConfig) -> bool:
        return True

    def alloc_buffers(self, x_like, cfg):
        return alloc_buffers(x_like, cfg)

    def sample_scan(
        self, eps_fn, x_init, buffers, schedule, cfg, lengths=None,
        steps=None, ts=None,
    ):
        eps_buf, t_buf = buffers
        return explicit_adams_scan(
            eps_fn, x_init, eps_buf, t_buf, schedule, cfg, steps=steps, ts=ts,
        )


class ImplicitAdamsPECEProgram(SolverProgram):
    """PECE's predictor and corrector are elementwise over positions: no
    solver-side sequence reduction to mask under ``lengths``."""

    name = "implicit_adams_pece"

    def supports_steps(self, cfg: SolverConfig) -> bool:
        return True

    def steps_for_nfe(self, nfe: int, cfg: SolverConfig) -> int:
        return pece_num_steps(nfe)

    def validate(self, req, cfg: SolverConfig) -> None:
        super().validate(req, cfg)
        if req.nfe < 2:
            raise ValueError(
                f"implicit_adams_pece spends 2 NFE per PECE step, so its "
                f"budget must be >= 2; got nfe={req.nfe}"
            )

    def alloc_buffers(self, x_like, cfg):
        return alloc_buffers(x_like, cfg, num_steps=pece_num_steps(cfg.nfe))

    def sample_scan(
        self, eps_fn, x_init, buffers, schedule, cfg, lengths=None,
        steps=None, ts=None,
    ):
        eps_buf, t_buf = buffers
        return implicit_adams_pece_scan(
            eps_fn, x_init, eps_buf, t_buf, schedule, cfg, steps=steps, ts=ts,
        )
