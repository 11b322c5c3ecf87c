"""NeuralODE layer (counterpart of ``regneuralde_tpu/models/neural_ode.py``).

The port routes one configuration of the JAX layer's fused options:
``fused="step"``, one normed Tsit5 trial-step kernel pair per trial step
(``ops.fused_mlp``), under the fast adjoint solve. ``fused=False`` runs the
same solve with no kernel: for ``MLPDynamics`` the kernels' plain PyTorch
versions (the same trial-step algebra, so the two paths differ only by
rounding), for any other dynamics the plain normed sweep over the module
with its autograd reverse. The whole-solve routes (``fused=True``,
``"solve"``, ``"tiled"``) and per-sample stepping are not ported yet and
raise ``NotImplementedError``; they are never remapped to another route.
The Hopper kernels mask a ragged row tile, so every batch size takes the
kernel path (no ``fused_tiling_ok`` gate).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from regneuralde_tpu_torch.models.basic import MLPDynamics
from regneuralde_tpu_torch.ops.ode import ODESolution, StepTelemetry, odeint



class NeuralDEOutput(NamedTuple):
    value: torch.Tensor  # the final state
    nfe: int
    telemetry: StepTelemetry
    solution: ODESolution


class NeuralODE(nn.Module):
    """du/dt = f(u, t; p), solved adaptively by ``ops.odeint``."""

    def __init__(
        self,
        dynamics: nn.Module,
        tspan: Tuple[float, float] = (0.0, 1.0),
        time_dep: bool = True,
        solver: str = "tsit5",
        rtol: float = 1.4e-8,
        atol: float = 1.4e-8,
        max_steps: int = 256,
        fused=False,
        per_sample=False,
        compensated_eest: bool = False,
    ):
        super().__init__()
        if compensated_eest and (fused or per_sample):
            raise ValueError("compensated_eest requires fused=False and "
                             "per_sample=False (generic sweep only)")
        if per_sample not in (False, True, "batched"):
            raise ValueError("per_sample must be False, True or 'batched', "
                             f"got {per_sample!r}")
        if fused not in (False, True, "step", "solve", "tiled"):
            raise ValueError("fused must be False, True, 'step', 'solve' or 'tiled'")
        if fused and not (solver == "tsit5" and isinstance(dynamics, MLPDynamics)):
            raise ValueError("fused requires solver='tsit5' and MLPDynamics dynamics")
        if fused in (True, "solve", "tiled"):
            raise NotImplementedError(
                f"fused={fused!r}: the whole-solve kernels K3-K6 are not ported yet "
                "(ROADMAP.md queue 1 item 10, queue 2)")
        if per_sample:
            raise NotImplementedError(
                f"per_sample={per_sample!r}: per-sample stepping (K11-K12) is "
                "not ported yet (ROADMAP.md queue 1 slice 5)")
        if compensated_eest:
            raise NotImplementedError("compensated_eest is not ported yet "
                                      "(ROADMAP.md queue 1 slice 6)")
        self.dynamics = dynamics
        self.tspan = tspan
        self.time_dep = time_dep
        self.solver = solver
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.fused = fused
        self._names = [name for name, _ in dynamics.named_parameters()]

    def _func(self, t, y, leaves):
        # The solver hands the parameters in as ``leaves`` (the adjoint
        # differentiates with respect to them), in ``parameters()`` order.
        params = dict(zip(self._names, leaves))
        inputs = (y, t) if self.time_dep else (y,)
        return torch.func.functional_call(self.dynamics, params, inputs)

    def forward(self, x: torch.Tensor, *, tspan: Optional[Tuple] = None,
                mode: str = "adjoint") -> NeuralDEOutput:
        t0, t1 = tspan if tspan is not None else self.tspan
        stage_sweep = stage_sweep_bwd = None
        if isinstance(self.dynamics, MLPDynamics) and self.solver == "tsit5":
            from regneuralde_tpu_torch.ops import fused_mlp as fm

            fwd, bwd = ((fm.mlp_dynamics_normed_sweep,
                         fm.mlp_dynamics_normed_sweep_bwd)
                        if self.fused == "step" else
                        (fm.plain_mlp_normed_sweep, fm.plain_mlp_normed_sweep_bwd))
            rtol, atol = self.rtol, self.atol
            stage_sweep = lambda t, dt, y, f0, p: fwd(t, dt, y, f0, p, rtol, atol)
            stage_sweep_bwd = lambda t, dt, y, k1, p, cts: bwd(
                t, dt, y, k1, p, cts, rtol, atol)
        sol = odeint(
            self._func, x, t0, t1, tuple(self.dynamics.parameters()),
            solver=self.solver,
            rtol=self.rtol, atol=self.atol, max_steps=self.max_steps,
            mode=mode, stage_sweep=stage_sweep, stage_sweep_bwd=stage_sweep_bwd,
        )
        return NeuralDEOutput(value=sol.y1, nfe=sol.stats.nfe,
                              telemetry=sol.telemetry, solution=sol)
