"""Adaptive DPM-Solver: PID-controlled accept/reject stepping (port of
``repro.core.dpm_adaptive``).

The DPM-Solver-12 scheme of Lu et al. 2022a (Sec. 3.3) with the PID
step-size controller of k-diffusion:

* each iteration advances in half-logSNR (lambda) space by a trial step
  ``h`` and computes an embedded order-1/2 pair that shares the first eps
  evaluation, ``x_low`` (DPM-Solver-1) and ``x_high`` (DPM-Solver-2,
  midpoint): 2 NFE an iteration;
* their difference over ``delta = max(atol, rtol * max(|x_low|,
  |x_prev|))`` is reduced to a per-row RMS error (masked to each row's
  valid positions under ``lengths``, through ERA's position-ordered sums);
* a PID controller turns the error into a step-size factor (limited by
  ``1 + atan(f - 1)``) and an accept/reject decision (``factor >=
  accept_safety``); a rejected step retries from the same state with the
  shrunken ``h``.

The loop has a fixed shape: ``nfe // 2`` iterations, each evaluating the
network twice over the whole batch; a row that has converged, or spent its
own iterations under a :class:`~repro_torch.core.program.StepMask`
(``active_steps`` caps its iterations; the controller picks its own times,
so the grids are not read), freezes bitwise.  Nothing in the loop reads a
value back to the host, so the executor captures it as one CUDA graph.
Each row's realized NFE stays on the device as the ``realized_nfe`` aux,
``(B,)`` int32; ``SolverOutput.nfe`` is the evaluations the batch made,
``2 * max(nfe // 2, 1)`` (the reference reports ``max(realized_nfe)``,
which would need a host sync).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.era import _seq_sq_sums
from repro_torch.core.program import SolverProgram, StepMask
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.core.solver_base import EpsFn, SolverConfig, SolverOutput

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdaptiveDPMConfig(SolverConfig):
    """Adaptive DPM-Solver options (defaults follow k-diffusion's
    ``sample_dpm_adaptive``).  ``nfe`` is the evaluation budget, 2 per
    iteration, not a step count."""

    rtol: float = 0.05           # relative tolerance
    atol: float = 0.0078         # absolute tolerance
    h_init: float = 0.35         # first trial step in lambda space
    pcoeff: float = 0.0          # PID proportional coefficient
    icoeff: float = 1.0          # PID integral coefficient
    dcoeff: float = 0.0          # PID derivative coefficient
    accept_safety: float = 0.81  # accept iff limited factor >= this
    pid_eps: float = 1e-8        # guards 1/error
    order: int = 2               # embedded pair order (PID normalization)


def num_iters(nfe: int) -> int:
    """One iteration costs 2 NFE: a budget B buys B // 2 iterations."""
    return max(nfe // 2, 1)


def sample_adaptive_scan(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: AdaptiveDPMConfig,
    lengths: Tensor | None = None,
    steps: StepMask | None = None,
) -> SolverOutput:
    """The adaptive loop.  Rows step independently: each keeps its own
    lambda, trial step, PID error history and done flag."""
    n_iters = num_iters(config.nfe)
    dt = config.solver_dtype
    b1 = (config.pcoeff + config.icoeff + config.dcoeff) / config.order
    b2 = -(config.pcoeff + 2.0 * config.dcoeff) / config.order
    b3 = config.dcoeff / config.order
    t_end = schedule.t_end if config.t_end is None else config.t_end

    x = x_init.to(dt)
    dev = x.device
    batch, nd = x.shape[0], x.dim()

    def row(v: Tensor) -> Tensor:
        return v.reshape(v.shape + (1,) * (nd - 1))

    # the lambda endpoints, made on the device from host floats by fills
    lam = schedule.lam(
        torch.full((batch,), schedule.t_begin, dtype=torch.float32, device=dev)
    )
    lam_end = schedule.lam(
        torch.full((), t_end, dtype=torch.float32, device=dev)
    )
    if lengths is not None and nd >= 3:
        valid = torch.arange(x.shape[1], device=dev) < lengths[:, None]
        numel = (lengths * math.prod(x.shape[2:])).to(torch.float32)
    else:
        valid = None
        numel = torch.full((batch,), float(x[0].numel()), dtype=torch.float32,
                           device=dev)
    x_prev = x
    h = torch.full((batch,), config.h_init, dtype=torch.float32, device=dev)
    e2 = torch.zeros((batch,), dtype=torch.float32, device=dev)
    e3 = torch.zeros_like(e2)
    seeded = torch.zeros((batch,), dtype=torch.bool, device=dev)
    done = torch.zeros_like(seeded)
    spent = torch.zeros((batch,), dtype=torch.int32, device=dev)
    traj = []
    for i in range(n_iters):
        act = ~done
        if steps is not None:
            act = act & (i < steps.active_steps)                # (B,)

        lam_next = torch.minimum(lam + h, lam_end)
        hh = lam_next - lam                                     # actual step
        tb = row(schedule.inv_lam(lam))
        tnb = row(schedule.inv_lam(lam_next))
        sb = row(schedule.inv_lam(lam + 0.5 * hh))
        hb = row(hh)
        a_t = schedule.alpha(tb)
        a_n, s_n = schedule.alpha(tnb), schedule.sigma(tnb)
        a_s, s_s = schedule.alpha(sb), schedule.sigma(sb)

        e_t = eps_fn(x, tb).to(dt)
        # DPM-Solver-1, the low-order member, shares e_t
        x_low = (a_n / a_t).to(dt) * x - (s_n * torch.expm1(hb)).to(dt) * e_t
        # DPM-Solver-2, midpoint r1 = 1/2
        u = (a_s / a_t).to(dt) * x - (
            s_s * torch.expm1(0.5 * hb)
        ).to(dt) * e_t
        e_s = eps_fn(u, sb).to(dt)
        x_high = x_low - (s_n * torch.expm1(hb)).to(dt) * (e_s - e_t)

        delta = torch.clamp(
            config.rtol * torch.maximum(x_low.abs(), x_prev.abs()),
            min=config.atol,
        )
        ratio = ((x_low - x_high) / delta).to(torch.float32)
        err = torch.sqrt(_seq_sq_sums(ratio, valid) / numel)    # (B,) RMS
        inv_err = 1.0 / (err + config.pid_eps)

        e2_eff = torch.where(seeded, e2, inv_err)
        e3_eff = torch.where(seeded, e3, inv_err)
        factor = inv_err**b1 * e2_eff**b2 * e3_eff**b3
        factor = 1.0 + torch.arctan(factor - 1.0)
        upd = act & (factor >= config.accept_safety)

        x = torch.where(row(upd), x_high, x)
        x_prev = torch.where(row(upd), x_low, x_prev)
        done = done | (upd & (lam_next >= lam_end))
        lam = torch.where(upd, lam_next, lam)
        h = torch.where(act, h * factor, h)
        e2, e3 = (
            torch.where(upd, inv_err, torch.where(act, e2_eff, e2)),
            torch.where(upd, e2_eff, torch.where(act, e3_eff, e3)),
        )
        seeded = seeded | act
        spent = spent + 2 * act.to(torch.int32)
        if config.return_trajectory:
            traj.append(x)

    aux: dict = {"realized_nfe": spent}
    if config.return_trajectory:
        aux["trajectory"] = torch.stack([x_init.to(dt), *traj])
    return SolverOutput(x0=x.to(x_init.dtype), nfe=2 * n_iters, aux=aux)


def sample(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: AdaptiveDPMConfig,
    device: str | torch.device | None = None,
) -> SolverOutput:
    """Self-contained entry on ``device`` (the card unless the caller
    passes ``"cpu"``)."""
    return AdaptiveDPMProgram().sample(eps_fn, x_init, schedule, config,
                                       device=device)


class AdaptiveDPMProgram(SolverProgram):
    """The error RMS is masked per row through ``lengths`` (pad positions
    add exact zeros to the position-ordered sums), so seq bucketing cannot
    move a row's accept decisions."""

    name = "dpm_adaptive"
    config_cls = AdaptiveDPMConfig
    aux_row_axes = {"trajectory": 1, "realized_nfe": 0}
    aux_seq_axes = {"trajectory": 2}
    aux_step_axes = {"trajectory": 0}

    def per_sample_state(self, cfg) -> bool:
        # the lambda position, step size and PID history are all (B,)
        return True

    def supports_steps(self, cfg: AdaptiveDPMConfig) -> bool:
        return True

    def steps_for_nfe(self, nfe: int, cfg: AdaptiveDPMConfig) -> int:
        return num_iters(nfe)

    def validate(self, req, cfg: AdaptiveDPMConfig) -> None:
        super().validate(req, cfg)
        if req.nfe < 2:
            raise ValueError(
                f"dpm_adaptive spends 2 NFE per accept/reject iteration, "
                f"so its budget must be >= 2; got nfe={req.nfe}"
            )
        if cfg.rtol <= 0.0 or cfg.atol <= 0.0:
            raise ValueError(
                f"dpm_adaptive tolerances must be positive, got "
                f"rtol={cfg.rtol}, atol={cfg.atol}"
            )
        if cfg.rtol < 1e-5 and cfg.atol < 1e-5:
            raise ValueError(
                f"dpm_adaptive tolerances rtol={cfg.rtol}, atol={cfg.atol} "
                f"are below the serveable floor (1e-5): the controller "
                f"cannot meet them within any finite NFE bucket, so the "
                f"request would always exhaust its budget unconverged"
            )
        if cfg.accept_safety >= 1.0 + math.pi / 2:
            raise ValueError(
                f"dpm_adaptive accept_safety={cfg.accept_safety} exceeds "
                f"the limiter ceiling 1 + pi/2: no step could ever be "
                f"accepted"
            )

    def sample_scan(
        self, eps_fn, x_init, buffers, schedule, cfg, lengths=None,
        steps=None, ts=None,
    ):
        return sample_adaptive_scan(eps_fn, x_init, schedule, cfg,
                                    lengths=lengths, steps=steps)
