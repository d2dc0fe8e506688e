"""Solver registry of the port.  Only ERA is ported so far, with the
seq-length and step-mask channels the executor's buckets use; the
baselines (DDIM, explicit and implicit Adams, DPM-Solver 2 / fast / ++2M,
adaptive DPM) and their step-masked loops wait for ROADMAP queue 1."""

from __future__ import annotations

from typing import Callable

from repro_torch.core import era
from repro_torch.core.program import SolverProgram
from repro_torch.core.solver_base import SolverOutput

SampleFn = Callable[..., SolverOutput]

_PROGRAMS: dict[str, SolverProgram] = {
    "era": era.ERAProgram(),
}


def get_program(name: str) -> SolverProgram:
    program = _PROGRAMS.get(name)
    if program is None:
        raise ValueError(
            f"unknown or not yet ported solver {name!r}; "
            f"available: {sorted(_PROGRAMS)}"
        )
    return program


def get_solver(name: str) -> SampleFn:
    """The functional entry: ``f(eps_fn, x_T, schedule, cfg)``."""
    return get_program(name).sample

