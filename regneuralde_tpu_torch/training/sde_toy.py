"""The toy 2-D SDE fit at its published configuration.

Counterpart of ``experiments/sde_toy.py`` with ``experiments/configs/
sde_toy.yml``: ``NeuralSDE(CubicDrift(2, 50), Dense(2))`` (the drift ``x ->
x^3 -> 50 tanh -> 2``, a diagonal diffusion), 100 trajectories from ``u0 =
[2, 0]`` over ``tspan = (0, 1 + eps_f32)``, saved at the 30 stamps of
``data.make_sde_demo``, SOSRI at rtol=atol=3e-1 with at most 256 trial
steps; the loss is the squared distance of the trajectories' per-stamp means
and (population) variances to the ground truth, plus ``0.2 *
error_estimate(telemetry, "sum")``; AdaBelief(0.01). ``fused=False`` is the
experiment's own route (``ops.sde.sdeint``), ``fused=True`` the whole-solve
kernels K9/K10 with the cubic tile body.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from regneuralde_tpu_torch import reg
from regneuralde_tpu_torch.models.basic import MLP
from regneuralde_tpu_torch.models.neural_sde import CubicDrift, NeuralSDE

# experiments/configs/sde_toy.yml and experiments/sde_toy.py
SEED = 5
TRAJECTORIES = 100
REG_COEFF = 0.2
MAX_STEPS = 256
TOL = 3e-1
T1 = 1.0 + float(np.finfo(np.float32).eps)


def build_sde_toy(saveat, fused=False, *, device="cuda",
                  generator: Optional[torch.Generator] = None) -> NeuralSDE:
    """The toy's ``NeuralSDE`` saving at ``saveat`` (the ground truth's
    stamps), weights from ``generator``."""
    return NeuralSDE(CubicDrift(2, 50, device=device, generator=generator),
                     MLP(2, (2,), device=device, generator=generator),
                     tspan=(0.0, T1), solver="sosri", rtol=TOL, atol=TOL,
                     max_steps=MAX_STEPS, saveat=torch.as_tensor(saveat, device=device),
                     fused=fused)


def sde_toy_u0(trajectories: int = TRAJECTORIES, device="cuda") -> torch.Tensor:
    """``trajectories`` copies of ``u0 = [2, 0]``."""
    return torch.tensor([[2.0, 0.0]], device=device).repeat(trajectories, 1)


def sde_toy_loss(model: NeuralSDE, u0, sde_means, sde_vars, noise):
    """``mean((means - m)^2) + mean((vars - v)^2) + 0.2 *
    error_estimate(telemetry, "sum")`` over the trajectory axis of the
    ``(traj, stamps, 2)`` solution on the Brownian draws ``noise``; ``vars``
    is the population variance, as ``jnp.var``. Returns ``(loss,
    NeuralSDEOutput)``."""
    out = model(u0, noise=noise)
    means = out.value.mean(0)
    vars_ = out.value.var(0, unbiased=False)
    return ((sde_means - means).square().mean() + (sde_vars - vars_).square().mean()
            + REG_COEFF * reg.error_estimate(out.telemetry, "sum")), out
