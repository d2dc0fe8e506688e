"""Solver registry of the port (port of ``repro.core.registry``): every
solver the reference registers, each as a
:class:`~repro_torch.core.program.SolverProgram` the serving executor can
fuse, bucket and route requests to.

    from repro_torch.core import get_solver, ERAConfig
    out = get_solver("era")(eps_fn, x_T, schedule, ERAConfig(nfe=10, k=4))

    from repro_torch.core import get_program
    program = get_program("ddim")          # the serving-engine surface
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core import adams, ddim, dpm_adaptive, dpm_solver, era
from repro_torch.core.program import SolverProgram
from repro_torch.core.solver_base import SolverConfig, SolverOutput

SampleFn = Callable[..., SolverOutput]

_PROGRAMS: dict[str, SolverProgram] = {
    # baselines the paper compares against
    "ddim": ddim.DDIMProgram(),
    "explicit_adams": adams.ExplicitAdamsProgram(),         # PNDM/FON family
    "implicit_adams_pece": adams.ImplicitAdamsPECEProgram(),
    "dpm_solver_2": dpm_solver.DPMSolverProgram(
        "dpm_solver_2", order=2, fast=False
    ),
    "dpm_solver_fast": dpm_solver.DPMSolverProgram(
        "dpm_solver_fast", order=3, fast=True
    ),
    "dpm_solver_pp2m": dpm_solver.DPMpp2MProgram(),
    "dpm_adaptive": dpm_adaptive.AdaptiveDPMProgram(),
    # the paper's contribution
    "era": era.ERAProgram(),
}


def get_program(name: str) -> SolverProgram:
    program = _PROGRAMS.get(name)
    if program is None:
        raise ValueError(
            f"unknown solver {name!r}; available: {sorted(_PROGRAMS)}"
        )
    return program


def get_solver(name: str) -> SampleFn:
    """The functional entry: ``f(eps_fn, x_T, schedule, cfg)``."""
    return get_program(name).sample


def solver_names() -> list[str]:
    return sorted(_PROGRAMS)


def default_config(name: str, **kw) -> SolverConfig:
    return get_program(name).default_config(**kw)
