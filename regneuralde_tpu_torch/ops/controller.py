"""PI step-size control and the initial-dt heuristic.

Counterpart of ``regneuralde_tpu/ops/controller.py``: OrdinaryDiffEq's
Tsit5 defaults (beta1 = 7/(10 order), beta2 = 2/(5 order), qmin = 1/5,
qmax = 10, gamma = 9/10, qoldinit = 1e-4) plus the step-keeping deadband
``qsteady_max = 1.2``, which keeps f32 noise in the error estimate from
ratcheting dt down. All arithmetic is on tensors and differentiable, so
gradients flow through dt into the ``EEst * dt`` regularizer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from regneuralde_tpu_torch.ops.norms import hairer_norm

_EEST_FLOOR = 1e-10  # guards 0^beta and its infinite derivative


@dataclasses.dataclass(frozen=True)
class PIController:
    beta1: float
    beta2: float
    qmin: float = 0.2
    qmax: float = 10.0
    gamma: float = 0.9
    qoldinit: float = 1e-4
    qsteady_max: float = 1.2  # 1.0 reproduces OrdinaryDiffEq exactly

    @classmethod
    def for_order(cls, order: int) -> "PIController":
        return cls(beta1=7.0 / (10.0 * order), beta2=2.0 / (5.0 * order))

    def propose(self, dt, eest, qold, accept):
        """One controller update on 0-d tensors: ``(dt_next, qold_next)``."""
        one = torch.ones_like(eest)
        eest_safe = torch.maximum(eest, one * _EEST_FLOOR)
        q11 = eest_safe ** self.beta1
        q = q11 / (qold ** self.beta2)
        q_acc = torch.minimum(torch.maximum(q / self.gamma, one / self.qmax),
                              one / self.qmin)
        if self.qsteady_max > 1.0:
            in_band = (q_acc >= 1.0) & (q_acc <= self.qsteady_max)
            q_acc = torch.where(in_band, one, q_acc)
        dt_acc = dt / q_acc
        qold_acc = torch.maximum(eest, one * self.qoldinit)
        q_rej = torch.minimum(one / self.qmin, q11 / self.gamma)
        dt_rej = dt / q_rej
        return torch.where(accept, dt_acc, dt_rej), torch.where(accept, qold_acc, qold)


def initial_step_size(func: Callable, t0, y0, f0, args, order: int, rtol,
                      atol, t1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hairer's initial step (one extra evaluation): ``(dt0, f_probe)``."""
    tdir = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)
    scale = atol + torch.abs(y0) * rtol
    d0 = hairer_norm(y0 / scale)
    d1 = hairer_norm(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    dt0 = torch.where(small, torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    dt0 = torch.minimum(dt0, span.to(dt0.dtype))

    y1 = y0 + (tdir * dt0) * f0
    f1 = func(t0 + tdir * dt0, y1, args)
    d2 = hairer_norm((f1 - f0) / scale) / dt0

    dmax = torch.maximum(d1, d2)
    dt1 = torch.where(dmax <= 1e-15,
                      torch.maximum(torch.full_like(dt0, 1e-6), dt0 * 1e-3),
                      (0.01 / dmax) ** (1.0 / (order + 1)))
    dt = torch.minimum(torch.minimum(100.0 * dt0, dt1), span.to(dt0.dtype))
    return tdir * dt, f1
