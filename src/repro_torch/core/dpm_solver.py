"""DPM-Solver baselines (Lu et al. 2022a): singlestep orders 1-3, the
"fast" mixed-order plan, and DPM-Solver++(2M) (port of
``repro.core.dpm_solver``).

Exponential-integrator solvers in half-logSNR (lambda) space: the linear
term of the diffusion ODE is integrated exactly, the eps nonlinearity is
approximated by a Taylor expansion.  DPM-Solver-2 costs 2 NFE a step,
DPM-Solver-3 3; DPM-Solver-fast mixes orders to spend an NFE budget
exactly.  The singlestep plan depends on the NFE, so those programs do not
support step masking; DPM-Solver++(2M), 1 NFE a step, does.

Both step on a lambda-uniform grid, which each program's ``step_times``
returns: the executor copies it to the device once and hands it to the
loop, so a captured loop makes no host-to-device copy.  A singlestep run
steps ``len(plan)`` intervals, not ``nfe``.
"""

from __future__ import annotations

import torch

from repro_torch.core.program import (
    SolverProgram,
    StepMask,
    step_active,
    trajectory_aux,
)
from repro_torch.core.schedules import NoiseSchedule, timesteps
from repro_torch.core.solver_base import (
    EpsFn,
    SolverConfig,
    SolverOutput,
    loop_grid,
)

Tensor = torch.Tensor


def _step1(eps_fn, sched, x, t, t_next):
    """DPM-Solver-1 (DDIM in lambda space), 1 NFE."""
    h = sched.lam(t_next) - sched.lam(t)
    e = eps_fn(x, t)
    return (sched.alpha(t_next) / sched.alpha(t)) * x - sched.sigma(
        t_next
    ) * torch.expm1(h) * e


def _step2(eps_fn, sched, x, t, t_next, r1=0.5):
    """DPM-Solver-2 (midpoint), 2 NFE."""
    lam_t = sched.lam(t)
    h = sched.lam(t_next) - lam_t
    s = sched.inv_lam(lam_t + r1 * h)
    e_t = eps_fn(x, t)
    u = (sched.alpha(s) / sched.alpha(t)) * x - sched.sigma(s) * torch.expm1(
        r1 * h
    ) * e_t
    e_s = eps_fn(u, s)
    return (
        (sched.alpha(t_next) / sched.alpha(t)) * x
        - sched.sigma(t_next) * torch.expm1(h) * e_t
        - sched.sigma(t_next) / (2.0 * r1) * torch.expm1(h) * (e_s - e_t)
    )


def _step3(eps_fn, sched, x, t, t_next, r1=1.0 / 3.0, r2=2.0 / 3.0):
    """DPM-Solver-3 (Lu et al. Algorithm 2), 3 NFE."""
    lam_t = sched.lam(t)
    h = sched.lam(t_next) - lam_t
    s1 = sched.inv_lam(lam_t + r1 * h)
    s2 = sched.inv_lam(lam_t + r2 * h)
    a_t = sched.alpha(t)
    e_t = eps_fn(x, t)
    u1 = (sched.alpha(s1) / a_t) * x - sched.sigma(s1) * torch.expm1(r1 * h) * e_t
    d1 = eps_fn(u1, s1) - e_t
    u2 = (
        (sched.alpha(s2) / a_t) * x
        - sched.sigma(s2) * torch.expm1(r2 * h) * e_t
        - (sched.sigma(s2) * r2 / r1) * (torch.expm1(r2 * h) / (r2 * h) - 1.0) * d1
    )
    d2 = eps_fn(u2, s2) - e_t
    return (
        (sched.alpha(t_next) / a_t) * x
        - sched.sigma(t_next) * torch.expm1(h) * e_t
        - (sched.sigma(t_next) / r2) * (torch.expm1(h) / h - 1.0) * d2
    )


_STEPS = {1: _step1, 2: _step2, 3: _step3}


def _order_plan(nfe: int, max_order: int) -> list[int]:
    """DPM-Solver-fast order sequence (Lu et al. Sec. 3.4)."""
    if max_order == 2:
        plan = [2] * (nfe // 2)
        if nfe % 2:
            plan.append(1)
        return plan
    # max_order == 3
    if nfe % 3 == 0:
        return [3] * (nfe // 3 - 1) + [2, 1]
    if nfe % 3 == 1:
        return [3] * (nfe // 3) + [1]
    return [3] * (nfe // 3) + [2]


def order_plan(nfe: int, order: int, fast: bool) -> list[int]:
    """The orders of a singlestep run that spends exactly ``nfe``."""
    if fast:
        return _order_plan(nfe, order)
    plan = [order] * (nfe // order)
    if nfe % order:
        plan.append(nfe % order)
    return plan


def sample(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: SolverConfig,
    order: int = 3,
    fast: bool = True,
    ts: Tensor | None = None,
) -> SolverOutput:
    """DPM-Solver with an exact NFE budget: ``order=2, fast=False`` gives
    the DPM-Solver-2 rows, ``order=3, fast=True`` the DPM-Solver-fast rows
    of the paper's tables.  Steps are uniform in lambda; ``ts`` is that
    ``(len(plan) + 1,)`` grid on ``x_init``'s device (None builds it)."""
    plan = order_plan(config.nfe, order, fast)
    ts = loop_grid(ts, schedule, len(plan), "logsnr", config.t_end,
                   x_init.device)
    x = x_init.to(config.solver_dtype)
    for i, o in enumerate(plan):
        x = _STEPS[o](eps_fn, schedule, x, ts[i], ts[i + 1])
    return SolverOutput(x0=x.to(x_init.dtype), nfe=sum(plan), aux={})


def sample_pp2m_scan(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: SolverConfig,
    steps: StepMask | None = None,
    ts: Tensor | None = None,
) -> SolverOutput:
    """DPM-Solver++(2M) (Lu et al. 2022b), the multistep data-prediction
    variant the paper benchmarks against on Stable Diffusion (Appendix E).

    In x0-space: x0_i = (x - sigma eps) / alpha;
      D_i = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1},  r_i = h_{i-1}/h_i
      x_{i+1} = (sigma_{i+1}/sigma_i) x_i - alpha_{i+1} expm1(-h_i) D_i
    1 NFE per step, second order; the carry is ``(x, x0_prev)``.  Under
    ``steps`` the coefficients come from each row's own time columns, step
    by step (as the reference computes them), and a spent row freezes
    bitwise, its ``x0_prev`` too (its padded grid has h = 0, which would
    give NaN)."""
    n = config.nfe
    dt = config.solver_dtype
    nd = x_init.dim()
    if steps is None:
        ts = loop_grid(ts, schedule, n, "logsnr", config.t_end, x_init.device)
        lam = schedule.lam(ts)
        alpha, sigma = schedule.alpha(ts), schedule.sigma(ts)

    def col(j: int) -> Tensor:
        return steps.ts[:, j].reshape((-1,) + (1,) * (nd - 1))

    x = x_init.to(dt)
    x0_prev = torch.zeros_like(x)
    traj = []
    for i in range(n):
        if steps is None:
            t_cur = ts[i]
            l_i, l_ip1, l_im1 = lam[i], lam[i + 1], lam[max(i - 1, 0)]
            a_i, a_ip1 = alpha[i], alpha[i + 1]
            s_i, s_ip1 = sigma[i], sigma[i + 1]
        else:
            t_cur, t_ip1 = col(i), col(i + 1)
            l_i, l_ip1 = schedule.lam(t_cur), schedule.lam(t_ip1)
            l_im1 = schedule.lam(col(max(i - 1, 0)))
            a_i, a_ip1 = schedule.alpha(t_cur), schedule.alpha(t_ip1)
            s_i, s_ip1 = schedule.sigma(t_cur), schedule.sigma(t_ip1)
        e = eps_fn(x, t_cur).to(dt)
        x0 = (x - s_i.to(dt) * e) / a_i.to(dt)
        h = l_ip1 - l_i
        if i > 0:
            coef = 1.0 / (2.0 * ((l_i - l_im1) / h))
            d = (1.0 + coef).to(dt) * x0 - coef.to(dt) * x0_prev
        else:  # order-1 warm-up step
            d = x0
        x_next = (s_ip1 / s_i).to(dt) * x - (
            a_ip1 * torch.expm1(-h)
        ).to(dt) * d
        if steps is not None:
            act = step_active(steps, i, nd)
            x_next = torch.where(act, x_next, x)
            x0 = torch.where(act, x0, x0_prev)
        if config.return_trajectory:
            traj.append(x_next)
        x, x0_prev = x_next, x0
    aux = trajectory_aux(x_init, traj, config.return_trajectory, dtype=dt)
    return SolverOutput(x0=x.to(x_init.dtype), nfe=n, aux=aux)


def sample_pp2m(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: SolverConfig,
    device: str | torch.device | None = None,
) -> SolverOutput:
    """Self-contained DPM++(2M) entry on ``device`` (the card unless the
    caller passes ``"cpu"``)."""
    return DPMpp2MProgram().sample(eps_fn, x_init, schedule, config,
                                   device=device)


class DPMpp2MProgram(SolverProgram):
    """DPM++(2M)'s multistep combine is elementwise over positions: no
    solver-side sequence reduction to mask under ``lengths``."""

    name = "dpm_solver_pp2m"

    def validate(self, req, cfg: SolverConfig) -> None:
        super().validate(req, cfg)
        if req.nfe < 2:
            raise ValueError(
                f"dpm_solver_pp2m is a 2-step multistep method whose first "
                f"step is order-1 warmup; it needs nfe >= 2, got "
                f"nfe={req.nfe}"
            )

    def supports_steps(self, cfg: SolverConfig) -> bool:
        return True

    def step_times(self, schedule, nfe, cfg, device="cpu"):
        # the loop pins its grid to logSNR spacing whatever cfg.scheme says
        return timesteps(schedule, nfe, "logsnr", t_end=cfg.t_end,
                         device=device)

    def sample_scan(
        self, eps_fn, x_init, buffers, schedule, cfg, lengths=None,
        steps=None, ts=None,
    ):
        return sample_pp2m_scan(eps_fn, x_init, schedule, cfg, steps=steps,
                                ts=ts)


class DPMSolverProgram(SolverProgram):
    """Singlestep DPM-Solver (order 2, or order 3 with the "fast" mixed
    plan).  Its updates are elementwise over positions; its plan depends
    on the NFE, so it has no step-masked variant and its traffic groups by
    exact NFE.  ``steps_for_nfe`` and ``step_times`` describe the plan's
    ``len(plan)`` lambda-uniform intervals."""

    def __init__(self, name: str, order: int, fast: bool):
        self.name = name
        self.order = order
        self.fast = fast

    def steps_for_nfe(self, nfe: int, cfg: SolverConfig) -> int:
        return len(order_plan(nfe, self.order, self.fast))

    def step_times(self, schedule, nfe, cfg, device="cpu"):
        return timesteps(schedule, self.steps_for_nfe(nfe, cfg), "logsnr",
                         t_end=cfg.t_end, device=device)

    def sample_scan(
        self, eps_fn, x_init, buffers, schedule, cfg, lengths=None,
        steps=None, ts=None,
    ):
        if steps is not None:
            raise ValueError(f"{self.name} does not support step masking")
        return sample(eps_fn, x_init, schedule, cfg, order=self.order,
                      fast=self.fast, ts=ts)
