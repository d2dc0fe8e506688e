"""ERA-Solver (the paper's Algorithm 1) — port of ``repro.core.era``.

Implicit-Adams (Adams--Moulton order 4) corrector whose unobserved term is
predicted by a Lagrange interpolation over an error-robustly selected
subset of previously observed network noises.  One NFE per step.

Step i (i >= k-1; the first k-1 steps are DDIM warmup while the buffer
fills):

  1. select bases  tau_{1..k}  via ERS (Eq. 16/17) from delta_eps
  2. predict       eps_bar_{i+1} = L_eps(t_{i+1})            (Eq. 13/14)
  3. correct       eps_ti = (9 eps_bar + 19 eps_i - 5 eps_{i-1}
                             + eps_{i-2}) / 24               (Eq. 11)
  4. x-update      x_{i+1} = DDIM(x_i, eps_ti)               (Eq. 8)
  5. observe       eps_{i+1} = eps_theta(x_{i+1}, t_{i+1})   (1 NFE)
  6. measure       delta_eps = || eps_{i+1} - eps_bar_{i+1} ||_2   (Eq. 15)

The final step skips 5/6, so a run of N steps costs exactly N NFE.

Port notes: the reference's ``lax.scan`` is a host loop over steps whose
tensors (latents, Lagrange buffers, delta_eps, selections) stay on the
device; ``lax.cond`` on the step index is a Python branch.  Steps 2-4 run
through :func:`repro_torch.kernels.era_update.era_update` — the Triton
kernel on the card, its plain version for CPU tensors — in one launch per
step for the whole batch.  There is no parity gate that degrades to
another path: a CUDA tensor launches the kernel or raises.

The loop makes no host-to-device copy and no host sync once its time grid
is on the device (``ts``, or ``steps.ts`` under step masking), so the
serving executor captures a whole run as one CUDA graph and replays it.
Under a :class:`~repro_torch.core.program.StepMask` every row reads its
own times and DDIM coefficients, a spent row's latents freeze bitwise (the
fused step copies them), and each row skips the observation after its own
last step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import lagrange
from repro_torch.core.program import (
    SolverProgram,
    StepMask,
    step_active,
    step_row_times,
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
from repro_torch.kernels.era_update import era_update
from repro_torch.kernels.rownorm import row_sq_sums

Tensor = torch.Tensor

# Adams--Moulton order-4 corrector coefficients (paper Eq. 10/11).
AM4 = (9.0 / 24.0, 19.0 / 24.0, -5.0 / 24.0, 1.0 / 24.0)


@dataclasses.dataclass(frozen=True)
class ERAConfig(SolverConfig):
    """ERA-Solver options (defaults follow the paper's main setting)."""

    k: int = 4                     # Lagrange interpolation order
    lam: float = 5.0               # power-scale hyperparameter (Eq. 17)
    selection: str = "ers"         # "ers" | "fixed" | "const"
    const_power: float = 1.0       # used when selection == "const"
    error_norm: str = "global"     # "global" (Eq. 15) | "mean"
    # beyond-paper: independent delta_eps + base selection per batch row
    per_sample: bool = False


def _seq_sq_sums(d: Tensor, valid: Tensor | None) -> Tensor:
    """Per-row sum of squared entries, features first, then accumulated
    position by position so zero-masked pad positions only append exact
    ``+ 0`` steps (:func:`repro_torch.kernels.rownorm.row_sq_sums`: on the
    card a kernel whose order depends on the row's width alone, not on the
    batch).  Rank-2 inputs keep the plain squared norm."""
    return row_sq_sums(d, valid)


def _delta_eps_batch(
    e_obs: Tensor, e_pred: Tensor, valid: Tensor | None = None
) -> Tensor:
    """Per-sample L2 errors (B,), reduced only over valid positions."""
    return torch.sqrt(_seq_sq_sums(e_obs - e_pred, valid))


def _delta_eps(
    e_obs: Tensor, e_pred: Tensor, mode: str, valid: Tensor | None = None
) -> Tensor:
    if mode == "global":
        d = (e_obs - e_pred).to(torch.float32)
        if valid is None:
            return torch.linalg.vector_norm(d.reshape(-1))
        return torch.sqrt(torch.sum(_seq_sq_sums(d, valid)))
    if mode == "mean":  # per-sample L2, averaged — batch-size invariant
        return torch.mean(_delta_eps_batch(e_obs, e_pred, valid))
    raise ValueError(f"unknown error_norm {mode!r}")


def era_combine(
    eps_sel: Tensor,     # (k, *x) selected buffer noises
    t_sel: Tensor,       # (k,) their times
    e_hist: Tensor,      # (3, *x) eps at steps i, i-1, i-2
    t_next,
) -> tuple[Tensor, Tensor]:
    """Predictor + corrector combine: returns (eps_bar_next, eps_corr).
    The unfused statement of steps 2-3 that the fused step is held to."""
    eps_bar = lagrange.interpolate(eps_sel, t_sel, t_next)
    c0, c1, c2, c3 = AM4
    eps_corr = c0 * eps_bar + c1 * e_hist[0] + c2 * e_hist[1] + c3 * e_hist[2]
    return eps_bar, eps_corr


def alloc_buffers(x: Tensor, config: ERAConfig) -> tuple[Tensor, Tensor]:
    """Fresh Lagrange eps/t buffers sized for ``config.nfe`` steps."""
    return buffer_init(x, config.nfe + 1, config.solver_dtype)


def sample(
    eps_fn: EpsFn,
    x_init: Tensor,
    schedule: NoiseSchedule,
    config: ERAConfig,
    device: str | torch.device | None = None,
) -> SolverOutput:
    """Self-contained entry on ``device`` (the card unless the caller
    passes ``"cpu"``): allocates buffers, then runs the loop."""
    return ERAProgram().sample(eps_fn, x_init, schedule, config, device=device)


def sample_scan(
    eps_fn: EpsFn,
    x_init: Tensor,
    eps_buf: Tensor,     # (nfe+1, *x.shape), updated in place
    t_buf: Tensor,       # (nfe+1,), updated in place
    schedule: NoiseSchedule,
    config: ERAConfig,
    lengths: Tensor | None = None,  # (B,) valid seq lengths of a right-
                                    # padded batch; masks the ERS norms
    steps: StepMask | None = None,  # mixed-NFE channel: per-row step
                                    # counts and time grids; a spent row
                                    # freezes bitwise
    ts: Tensor | None = None,       # (nfe+1,) grid on x's device when no
                                    # steps are given; None builds it
) -> SolverOutput:
    n, k = config.nfe, config.k
    if n < k:
        raise ValueError(f"ERA-Solver needs nfe >= k ({n} < {k})")
    if steps is not None and not config.per_sample:
        raise ValueError(
            "mixed-NFE step masking needs per-sample ERS (per_sample=True):"
            " a shared delta_eps would couple rows with different horizons"
        )
    if lengths is not None and x_init.dim() < 3:
        raise ValueError(
            "lengths masking needs batch-of-sequences latents (B, S, ...); "
            f"got x of rank {x_init.dim()}"
        )
    if tuple(eps_buf.shape) != (n + 1,) + tuple(x_init.shape):
        raise ValueError(
            f"eps buffer shape {tuple(eps_buf.shape)} != "
            f"{(n + 1,) + tuple(x_init.shape)}"
        )
    if tuple(t_buf.shape) != (n + 1,):
        raise ValueError(f"t buffer shape {tuple(t_buf.shape)} != {(n + 1,)}")
    dev = x_init.device
    batch = x_init.shape[0]
    if steps is not None:
        if tuple(steps.ts.shape) != (batch, n + 1):
            raise ValueError(
                f"step grid shape {tuple(steps.ts.shape)} != {(batch, n + 1)}"
            )
        # each row steps through its own grid; the shared t_buf holds 0.0
        # (Lagrange node times gather from steps.ts, the very floats an
        # exact run appends to its t_buf)
        t_cur0 = steps.ts[:, 0].reshape((-1,) + (1,) * (x_init.dim() - 1))
    else:
        ts = loop_grid(ts, schedule, n, config.scheme, config.t_end, dev)
        t_cur0 = ts[0]
    dt = config.solver_dtype
    valid = (
        None
        if lengths is None
        else torch.arange(x_init.shape[1], device=dev) < lengths[:, None]
    )  # (B, S) position-validity mask for the error norms
    # the fused step's rows: one per sample under per-sample ERS, else one
    # row spanning the whole batch (the reference's shared scalar delta_eps)
    rows = batch if config.per_sample else 1
    cap = n + 1

    x = x_init.to(dt)
    # Alg. 1 line 2/3: delta_eps starts at lambda (power 1, uniform
    # selection); the initial observation is entry 0
    buffer_append(eps_buf, t_buf, 0, eps_fn(x, t_cur0),
                  0.0 if steps is not None else t_cur0)
    delta_eps = torch.full(
        (batch,) if config.per_sample else (), config.lam,
        dtype=torch.float32, device=dev,
    )
    tau_shape = (batch, k) if config.per_sample else (k,)
    de_hist, tau_hist, traj = [], [], [x]
    for i in range(n):
        if steps is None:
            t_cur, t_next = ts[i], ts[i + 1]
            active = None
        else:
            t_cur, t_next = step_row_times(steps, i, x.dim())
            active = step_active(steps, i, x.dim())              # (B, 1, 1)
        if i < k - 1:
            # DDIM warmup; prediction placeholder is the held noise
            eps_bar = eps_buf[i]
            x_next = ddim_step(schedule, x, eps_bar, t_cur, t_next)
            if active is not None:
                x_next = torch.where(active, x_next, x)
            tau = torch.zeros(tau_shape, dtype=torch.int32, device=dev)
        else:
            tau = lagrange.select_bases(
                i, k, delta_eps, config.lam, config.selection,
                config.const_power,
            )
            if steps is None:
                t_sel = t_buf[tau.long()]
            else:
                t_sel = torch.gather(steps.ts, 1, tau.long())   # (B, k)
            lag_w = lagrange.lagrange_weights(
                t_sel, t_next if steps is None else t_next.reshape(-1)
            )
            cx, ce = schedule.ddim_coeffs(t_cur, t_next)  # () or (B, 1, 1)
            if steps is not None:
                cx, ce = cx.reshape(rows), ce.reshape(rows)
            # history entries i, i-1, i-2; a negative entry wraps to the
            # still-empty last slot, as the reference's dynamic index does
            hist = (i, (i - 1) % cap, (i - 2) % cap)
            # a spent row's kernel row copies x and writes eps_bar = 0
            x_next, eps_bar = era_update(
                x.reshape(rows, -1),
                eps_buf.reshape(cap, rows, -1),
                tau.reshape(rows, k).contiguous(),
                hist,
                lag_w.reshape(rows, k).contiguous(),
                AM4, cx, ce,
                active=None if active is None
                else active.reshape(rows).to(torch.int32),
            )
            x_next = x_next.reshape(x.shape)
            eps_bar = eps_bar.reshape(x.shape)
        # observe eps at the new point, except on the final step, whose
        # x_next is the output (exactly nfe evaluations); nothing reads the
        # buffer entry the reference fills with zeros there.  Under step
        # masking each row also skips the observation after its own last
        # step: it appends zeros and keeps its delta_eps
        if i + 1 < n:
            e_new = eps_fn(x_next, t_next).to(dt)
            obs = None if steps is None else step_active(steps, i + 1, x.dim())
            # Alg. 1 line 16: delta_eps updates once predictions are real
            if i >= k - 1:
                de_new = (
                    _delta_eps_batch(e_new, eps_bar, valid)
                    if config.per_sample
                    else _delta_eps(e_new, eps_bar, config.error_norm, valid)
                )
                delta_eps = (
                    de_new if obs is None
                    else torch.where(obs.reshape(rows), de_new, delta_eps)
                )
            if obs is not None:
                e_new = torch.where(obs, e_new, e_new.new_zeros(()))
            buffer_append(eps_buf, t_buf, i + 1, e_new,
                          0.0 if steps is not None else t_next)
        de_hist.append(delta_eps)
        tau_hist.append(tau)
        if config.return_trajectory:
            traj.append(x_next)
        x = x_next

    aux: dict[str, Any] = {}
    de_hist = torch.stack(de_hist)
    if config.per_sample:
        aux["delta_eps_history_per_sample"] = de_hist        # (nfe, B)
        aux["delta_eps_history"] = torch.mean(de_hist, dim=-1)
        aux["ers_selection_history"] = torch.stack(tau_hist)  # (nfe, B, k)
    else:
        aux["delta_eps_history"] = de_hist
    if config.return_trajectory:
        aux["trajectory"] = torch.stack(traj)                # (nfe+1, B, ...)
    return SolverOutput(x0=x.to(x_init.dtype), nfe=n, aux=aux)


class ERAProgram(SolverProgram):
    """ERA-Solver as a serving program.  The paper default shares one
    delta_eps across the batch, which couples rows, so it is not fusable;
    the engine default turns on per-sample ERS, which makes a batch-of-N
    run equal to N independent runs, and lets rows of different lengths
    and different step counts share a batch."""

    name = "era"
    config_cls = ERAConfig
    aux_row_axes = {
        "trajectory": 1,
        "delta_eps_history_per_sample": 1,
        "ers_selection_history": 1,
    }
    aux_step_axes = {
        "trajectory": 0,
        "delta_eps_history": 0,
        "delta_eps_history_per_sample": 0,
        "ers_selection_history": 0,
    }

    def engine_config(self) -> ERAConfig:
        return ERAConfig(per_sample=True)

    def fusable(self, cfg: ERAConfig) -> bool:
        return cfg.per_sample

    def per_sample_state(self, cfg: ERAConfig) -> bool:
        return cfg.per_sample

    def supports_lengths(self, cfg: ERAConfig) -> bool:
        """The ERS norms are masked and accumulate positions in order, so a
        padded row selects the bases its unpadded run selects; only
        per-sample ERS keeps one row's padding out of another's norm."""
        return cfg.per_sample

    def supports_steps(self, cfg: ERAConfig) -> bool:
        """Each row carries its own delta_eps and selections under
        per-sample ERS, so freezing a spent row cannot move a live one."""
        return cfg.per_sample

    def validate(self, req, cfg: ERAConfig) -> None:
        super().validate(req, cfg)
        if req.nfe < cfg.k:
            raise ValueError(
                f"ERA-Solver needs nfe >= k ({req.nfe} < {cfg.k}); "
                "lower k in the engine's solver_config or raise nfe"
            )

    def alloc_buffers(self, x_like, cfg: ERAConfig):
        return alloc_buffers(x_like, cfg)

    def sample_scan(
        self, eps_fn, x_init, buffers, schedule, cfg, lengths=None,
        steps=None, ts=None,
    ):
        eps_buf, t_buf = buffers
        return sample_scan(
            eps_fn, x_init, eps_buf, t_buf, schedule, cfg, lengths=lengths,
            steps=steps, ts=ts,
        )

    def merge_aux(self, parts: list[dict]) -> dict:
        """Row blocks joined; the batch-mean diagnostic taken again over
        all rows, as one unsplit run computes it."""
        merged = super().merge_aux(parts)
        if len(parts) > 1 and "delta_eps_history_per_sample" in merged:
            merged["delta_eps_history"] = torch.mean(
                merged["delta_eps_history_per_sample"], dim=-1)
        return merged

    def scope_aux(
        self, aux: dict, off: int, batch: int, seq_len: int | None = None,
        n_steps: int | None = None, padded_steps: int | None = None,
    ) -> dict:
        scoped = super().scope_aux(
            aux, off, batch, seq_len=seq_len, n_steps=n_steps,
            padded_steps=padded_steps,
        )
        if scoped is not aux and "delta_eps_history_per_sample" in scoped:
            # the batch-mean diagnostic covers only this request's rows
            scoped["delta_eps_history"] = torch.mean(
                scoped["delta_eps_history_per_sample"], dim=-1
            )
        return scoped
