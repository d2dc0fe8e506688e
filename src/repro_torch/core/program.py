"""Solver programs — the surface the serving executor calls (port of
``repro.core.program``).

A :class:`SolverProgram` is what the executor knows about a solver:
request policy (``fusable``, ``validate``), its history buffers
(``alloc_buffers``), the sampling loop (``sample_scan``), the two mask
channels of a fused batch (``supports_lengths`` for seq bucketing,
``supports_steps`` with :class:`StepMask` for NFE bucketing) and how a
fused batch's diagnostics are scoped to each request (``scope_aux``).  On a
mesh, ``per_sample_state`` / ``carry_pspecs`` give the reference's carry
specs, and ``merge_aux`` joins the diagnostics of a batch that ran as row
blocks on several devices.  The reference's ahead-of-time compile hooks
have no counterpart: the executor captures each bucket's loop as a CUDA
graph instead of compiling it.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import torch

from repro_torch.core.schedules import NoiseSchedule, timesteps
from repro_torch.device import resolve_device
from repro_torch.core.solver_base import EpsFn, SolverConfig, SolverOutput

Tensor = torch.Tensor


class StepMask(NamedTuple):
    """The mixed-NFE mask channel: per-row step activity for a batch whose
    rows run different step counts inside one loop of the bucket's
    ``n_steps`` iterations.  Step ``i`` is **active** for row ``r`` iff
    ``i < active_steps[r]``; an inactive step leaves that row's latents,
    history entries and ERS state bitwise unchanged.  Row ``r``'s own grid
    (``step_times`` for its exact NFE) occupies ``ts[r, : active_steps[r]
    + 1]``, with the terminal time repeated through the padded tail."""

    #: (B,) int32 — per-row count of real solver steps
    active_steps: Tensor
    #: (B, n_steps + 1) float32 — per-row time grids, terminal-padded
    ts: Tensor


def step_active(steps: StepMask, i: int, x_ndim: int = 3) -> Tensor:
    """Per-row activity predicate of step ``i``, shaped ``(B,) + (1,) *
    (x_ndim - 1)`` to broadcast against ``(B, ...)`` carries."""
    act = i < steps.active_steps
    return act.reshape(act.shape + (1,) * (x_ndim - 1))


def step_row_times(steps: StepMask, i: int, x_ndim: int = 3):
    """Row times ``(t_cur, t_next)`` of step ``i``, shaped ``(B,) + (1,) *
    (x_ndim - 1)`` so schedule coefficients broadcast per row."""
    trail = (1,) * (x_ndim - 1)
    t_cur, t_next = steps.ts[:, i], steps.ts[:, i + 1]
    return t_cur.reshape(t_cur.shape + trail), t_next.reshape(t_next.shape + trail)


class SolverProgram:
    """Base solver program: fusable, bufferless, batch-row-independent.
    Subclasses override the hooks their solver needs."""

    #: registry name (set by each concrete program)
    name: str = ""
    #: config dataclass this program consumes
    config_cls: type[SolverConfig] = SolverConfig
    #: aux keys whose value carries the padded batch on the given axis
    aux_row_axes: Mapping[str, int] = {"trajectory": 1}
    #: aux keys whose value carries the padded sequence on the given axis
    aux_seq_axes: Mapping[str, int] = {"trajectory": 2}
    #: aux keys stacked over loop steps on the given axis (scoped to a
    #: request's own step count under NFE bucketing)
    aux_step_axes: Mapping[str, int] = {"trajectory": 0}

    # ---- configs ---------------------------------------------------------
    def default_config(self, **kw) -> SolverConfig:
        """The paper-default config."""
        return self.config_cls(**kw)

    def engine_config(self) -> SolverConfig:
        """The serving-engine default config (isolation-safe)."""
        return self.config_cls()

    # ---- request policy --------------------------------------------------
    def fusable(self, cfg: SolverConfig) -> bool:
        """Can strangers (and pad rows) share a fused batch under ``cfg``?"""
        return True

    def per_sample_state(self, cfg: SolverConfig) -> bool:
        """Does the loop carry per-sample ``(B,)`` solver state that goes
        with its rows on a mesh (ERA's per-sample delta_eps)?"""
        return False

    def carry_pspecs(self, cfg: SolverConfig, mesh, *, batch=None, x_ndim=3):
        """The reference's partition specs of this program's carry on
        ``mesh`` (:func:`repro_torch.parallel.sharding.solver_carry_pspecs`)."""
        from repro_torch.parallel.sharding import solver_carry_pspecs

        return solver_carry_pspecs(mesh, self, cfg, batch=batch, x_ndim=x_ndim)

    def supports_lengths(self, cfg: SolverConfig) -> bool:
        """Can a right-padded batch with per-row ``lengths`` compute every
        valid position exactly as an unpadded run would?  True for math
        elementwise over positions; a program that reduces over the
        sequence must mask the reduction."""
        return True

    def supports_steps(self, cfg: SolverConfig) -> bool:
        """Can a mixed-NFE batch run under a :class:`StepMask`: active
        steps compute what an exact-NFE run would, inactive ones freeze
        the row bitwise?"""
        return False

    def steps_for_nfe(self, nfe: int, cfg: SolverConfig) -> int:
        """Solver steps a request with NFE budget ``nfe`` runs (the unit
        ``StepMask.active_steps`` counts in)."""
        return nfe

    def step_times(
        self, schedule: NoiseSchedule, nfe: int, cfg: SolverConfig,
        device: str | torch.device = "cpu",
    ) -> Tensor:
        """The exact ``(steps_for_nfe(nfe) + 1,)`` grid a request with
        budget ``nfe`` steps through; the executor builds each row of
        ``StepMask.ts`` (and each unmasked bucket's grid) from it."""
        return timesteps(
            schedule, self.steps_for_nfe(nfe, cfg), cfg.scheme,
            t_end=cfg.t_end, device=device,
        )

    def validate(self, req: Any, cfg: SolverConfig) -> None:
        """Reject an illegal request at submit time (``req`` needs
        ``.batch`` and ``.nfe``)."""
        if req.nfe < 1:
            raise ValueError(f"nfe must be >= 1, got {req.nfe}")

    # ---- buffers ---------------------------------------------------------
    def alloc_buffers(
        self, x_like: Tensor, cfg: SolverConfig
    ) -> tuple[Tensor, ...]:
        """Fresh history buffers for one sampling run (empty for
        history-free solvers)."""
        return ()

    # ---- the sampling loop -----------------------------------------------
    def sample_scan(
        self,
        eps_fn: EpsFn,
        x_init: Tensor,
        buffers: tuple[Tensor, ...],
        schedule: NoiseSchedule,
        cfg: SolverConfig,
        lengths: Tensor | None = None,
        steps: StepMask | None = None,
        ts: Tensor | None = None,
    ) -> SolverOutput:
        """The solver loop over the step grid with ``buffers`` threaded in.
        ``lengths`` (B,) marks per-row valid sequence lengths; ``steps``
        is the mixed-NFE channel (only for programs whose
        :meth:`supports_steps` is true); ``ts`` is the ``(nfe + 1,)`` grid
        on the device when no ``steps`` are given (None: built from the
        schedule)."""
        raise NotImplementedError

    def sample(
        self, eps_fn: EpsFn, x_init: Tensor, schedule: NoiseSchedule,
        cfg: SolverConfig, device: str | torch.device | None = None,
    ) -> SolverOutput:
        """Self-contained entry: moves ``x_init`` to ``device`` (the card
        unless the caller passes ``"cpu"``), allocates buffers, then runs
        the loop."""
        x_init = x_init.to(resolve_device(device))
        return self.sample_scan(
            eps_fn, x_init, self.alloc_buffers(x_init, cfg), schedule, cfg
        )

    # ---- aux scoping -----------------------------------------------------
    def scope_aux(
        self,
        aux: dict,
        off: int,
        batch: int,
        seq_len: int | None = None,
        n_steps: int | None = None,
        padded_steps: int | None = None,
    ) -> dict:
        """Scope diagnostics to one request: its rows ``[off, off +
        batch)`` per :attr:`aux_row_axes`, its valid positions ``[0,
        seq_len)`` per :attr:`aux_seq_axes` (None: it ran at its exact
        length), and, when the loop ran ``padded_steps`` steps but the
        request only ``n_steps``, the first ``n_steps``-worth of each
        :attr:`aux_step_axes` entry (keeping any extra leading frame, as
        the trajectory's initial state).  No batch-mate, pad-row,
        pad-position or pad-step leakage."""
        pad_steps = (
            0 if n_steps is None or padded_steps is None
            else padded_steps - n_steps
        )
        scoped, hit = dict(aux), False

        def cut(axes: Mapping[str, int], start: int, keep) -> None:
            nonlocal hit
            for key, axis in axes.items():
                if scoped.get(key) is not None:
                    value = scoped[key]
                    scoped[key] = value.narrow(axis, start, keep(value.shape[axis]))
                    hit = True

        cut(self.aux_row_axes, off, lambda n: batch)
        if seq_len is not None:
            cut(self.aux_seq_axes, 0, lambda n: seq_len)
        if pad_steps > 0:
            cut(self.aux_step_axes, 0, lambda n: n - pad_steps)
        return scoped if hit else aux


    def merge_aux(self, parts: list[dict]) -> dict:
        """The diagnostics of one batch that ran as contiguous row blocks
        (a fusable batch split over a mesh), in row order: each
        :attr:`aux_row_axes` entry joined on its row axis, on the first
        block's device; every other entry is the first block's."""
        if len(parts) == 1:
            return parts[0]
        dev = next((v.device for v in parts[0].values()
                    if isinstance(v, Tensor)), None)
        out = dict(parts[0])
        for key, axis in self.aux_row_axes.items():
            if parts[0].get(key) is not None:
                out[key] = torch.cat([p[key].to(dev) for p in parts], dim=axis)
        return out


def trajectory_aux(
    x_init: Tensor, traj_tail: list[Tensor], enabled: bool, dtype=None
) -> dict[str, Tensor]:
    """The ``trajectory`` aux ``(steps + 1, B, ...)``: the initial state
    (cast to ``dtype`` when given), then the loop's per-step latents."""
    if not enabled:
        return {}
    x0 = x_init if dtype is None else x_init.to(dtype)
    return {"trajectory": torch.stack([x0, *traj_tail])}
