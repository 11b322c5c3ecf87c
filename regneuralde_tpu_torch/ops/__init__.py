"""Solver core: Tsit5 tableau, PI controller, normed sweeps, fast adjoint;
per-sample adaptive stepping; the SRI tableaus and the adaptive SDE solve."""

from regneuralde_tpu_torch.ops.controller import PIController, initial_step_size
from regneuralde_tpu_torch.ops.math import tanh
from regneuralde_tpu_torch.ops.norms import error_ratio, hairer_norm
from regneuralde_tpu_torch.ops.ode import (
    NormedSweep,
    ODESolution,
    ODEStats,
    StepTelemetry,
    odeint,
)
from regneuralde_tpu_torch.ops.per_sample import odeint_per_sample
from regneuralde_tpu_torch.ops.per_sample_batched import odeint_per_sample_batched
from regneuralde_tpu_torch.ops.sde import SDESolution, SDEStats, presample_noise, sdeint
from regneuralde_tpu_torch.ops.sri import SRITableau, get_tableau, stability_size
from regneuralde_tpu_torch.ops.tableaus import TSIT5

__all__ = [
    "NormedSweep", "ODESolution", "ODEStats", "PIController", "SDESolution", "SDEStats",
    "SRITableau", "StepTelemetry", "TSIT5", "error_ratio", "get_tableau", "hairer_norm",
    "initial_step_size", "odeint", "odeint_per_sample", "odeint_per_sample_batched",
    "presample_noise", "sdeint", "stability_size", "tanh",
]
