"""Solver core: Tsit5 tableau, PI controller, normed sweeps, fast adjoint."""

from regneuralde_tpu_torch.ops.controller import PIController, initial_step_size
from regneuralde_tpu_torch.ops.math import tanh
from regneuralde_tpu_torch.ops.norms import hairer_norm
from regneuralde_tpu_torch.ops.ode import (
    NormedSweep,
    ODESolution,
    ODEStats,
    StepTelemetry,
    odeint,
)
from regneuralde_tpu_torch.ops.tableaus import TSIT5

__all__ = [
    "NormedSweep", "ODESolution", "ODEStats", "PIController", "StepTelemetry",
    "TSIT5", "hairer_norm", "initial_step_size", "odeint", "tanh",
]
