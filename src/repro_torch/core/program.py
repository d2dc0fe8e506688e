"""Solver programs — the surface the serving executor calls (port of
``repro.core.program``).

A :class:`SolverProgram` is what the executor knows about a solver:
request policy (``fusable``, ``validate``), its history buffers
(``alloc_buffers``), the sampling loop (``sample_scan``) and how a fused
batch's diagnostics are scoped to each request (``scope_aux``).  The mesh
placement and ahead-of-time compile hooks of the reference have no
counterpart yet, and the mixed-NFE ``StepMask`` waits for NFE bucketing.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.core.schedules import NoiseSchedule
from repro_torch.device import resolve_device
from repro_torch.core.solver_base import EpsFn, SolverConfig, SolverOutput

Tensor = torch.Tensor


class SolverProgram:
    """Base solver program: fusable, bufferless, batch-row-independent.
    Subclasses override the hooks their solver needs."""

    #: registry name (set by each concrete program)
    name: str = ""
    #: config dataclass this program consumes
    config_cls: type[SolverConfig] = SolverConfig
    #: aux keys whose value carries the padded batch on the given axis
    aux_row_axes: Mapping[str, int] = {"trajectory": 1}

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

    def steps_for_nfe(self, nfe: int, cfg: SolverConfig) -> int:
        """Solver steps a request with NFE budget ``nfe`` runs."""
        return nfe

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
    ) -> SolverOutput:
        """The solver loop over the step grid with ``buffers`` threaded in;
        ``lengths`` (B,) marks per-row valid sequence lengths."""
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
    def scope_aux(self, aux: dict, off: int, batch: int) -> dict:
        """Scope diagnostics to one request's rows ``[off, off + batch)``
        of a fused padded batch, per :attr:`aux_row_axes` (no batch-mate
        or pad-row leakage)."""
        hit = {
            k: ax for k, ax in self.aux_row_axes.items()
            if aux.get(k) is not None
        }
        if not hit:
            return aux
        scoped = dict(aux)
        for key, axis in hit.items():
            scoped[key] = scoped[key].narrow(axis, off, batch)
        return scoped
