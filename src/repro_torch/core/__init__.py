"""Solver core of the port: schedules, the solver programs (ERA and the
baselines the paper compares against) and their registry."""

from repro_torch.core.dpm_adaptive import AdaptiveDPMConfig
from repro_torch.core.era import ERAConfig, era_combine
from repro_torch.core.program import SolverProgram
from repro_torch.core.registry import (
    default_config,
    get_program,
    get_solver,
    solver_names,
)
from repro_torch.core.schedules import (
    NoiseSchedule,
    cosine_schedule,
    get_schedule,
    linear_schedule,
    timesteps,
)
from repro_torch.core.solver_base import SolverConfig, SolverOutput, ddim_step

__all__ = [
    "AdaptiveDPMConfig",
    "ERAConfig",
    "NoiseSchedule",
    "SolverConfig",
    "SolverOutput",
    "SolverProgram",
    "cosine_schedule",
    "ddim_step",
    "default_config",
    "era_combine",
    "get_program",
    "get_schedule",
    "get_solver",
    "linear_schedule",
    "solver_names",
    "timesteps",
]
