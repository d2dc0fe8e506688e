"""ERA-Solver core of the port: schedules, Lagrange selection, the ERA
sampling loop and its serving program."""

from repro_torch.core.era import ERAConfig, era_combine
from repro_torch.core.program import SolverProgram
from repro_torch.core.registry import get_program, get_solver
from repro_torch.core.schedules import (
    NoiseSchedule,
    cosine_schedule,
    linear_schedule,
    timesteps,
)
from repro_torch.core.solver_base import SolverConfig, SolverOutput, ddim_step

__all__ = [
    "ERAConfig",
    "NoiseSchedule",
    "SolverConfig",
    "SolverOutput",
    "SolverProgram",
    "cosine_schedule",
    "ddim_step",
    "era_combine",
    "get_program",
    "get_solver",
    "linear_schedule",
    "timesteps",
]
