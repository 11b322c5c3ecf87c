"""NeuralODE layer (counterpart of ``regneuralde_tpu/models/neural_ode.py``).

The port routes the JAX layer's fused options for ``MLPDynamics`` and
``AlternatingMLP``:

* ``fused=True``, ``"solve"`` and ``"tiled"`` with ``mode="adjoint"``: the
  whole solve, one kernel per direction (``ops.whole_solve``, K3/K4; the
  Hopper kernels stand for both TPU engines, the monolithic K3/K4 and the
  tiled K5/K6, so the three options take the same route), for
  ``MLPDynamics`` and ``AlternatingMLP``, with or without ``saveat``;
  ``"tiled"`` with ``saveat`` raises ``ValueError``, as in JAX;
* ``fused="step"``, and the whole-solve options in ``mode="while"`` or
  ``"scan"`` (as in JAX): one normed Tsit5 trial-step kernel pair per trial
  step, K1/K2 for ``MLPDynamics`` (``ops.fused_mlp``), K7/K8 for
  ``AlternatingMLP`` (``ops.fused_generic``), under the fast adjoint solve
  on ``"adjoint"`` and under autograd through every step on ``"scan"``;
* ``fused=False``: the same solves with no kernel: for those two dynamics
  the kernels' plain PyTorch versions (the same trial-step algebra, so the
  paths differ only by rounding); for any other dynamics, and for
  ``solver="dopri5"`` or ``"bosh3"``, ``odeint``'s generic sweep over the
  module (the replay adjoint on ``"adjoint"``).

``saveat`` gives the trajectory at the stamps, ``(batch, time, feat)``.

The Hopper kernels mask a ragged row tile and keep the batch in global
memory, so every batch size takes the kernel path: there is no
``fused_tiling_ok`` gate and no VMEM gate, and ``"tiled"`` has no
``batch % tile_rows`` limit. One difference from JAX follows: JAX sends
``fused=True`` past its VMEM estimate to the tiled engine or, with
``saveat``, to the step kernels (MLPDynamics at 512x784 with many saves);
the port runs the whole solve at every size.

``per_sample="batched"`` gives every batch row its own controller
(``ops.per_sample``'s batched engine, ``ops.per_sample_batched``); ``nfe``
and the solution's stats are then ``(batch,)`` tensors and the telemetry
``(batch, max_steps)``. With ``MLPDynamics``, ``fused=True`` or ``"step"``
runs the lane-wise trial-step kernels K11/K12 (``ops.fused_mlp_lanes``) and
``fused=False`` their plain versions (the same algebra, so the routes differ
only by rounding); other dynamics take the traced per-lane sweep over the
module. One difference from JAX, deliberate: JAX accepts any truthy
``fused`` with ``per_sample`` (``"solve"``/``"tiled"`` included, though no
whole solve has per-lane control); the port raises ``ValueError`` for
``"solve"`` and ``"tiled"``. Not ported yet, raising
``NotImplementedError`` and never remapped to another route:
``per_sample=True`` (the vmap engine).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from regneuralde_tpu_torch.models.basic import AlternatingMLP, MLPDynamics
from regneuralde_tpu_torch.ops.ode import ODESolution, StepTelemetry, odeint

_WHOLE_SOLVE = (True, "solve", "tiled")


class NeuralDEOutput(NamedTuple):
    value: torch.Tensor  # the final state, or (batch, time, feat) at saveat
    nfe: Union[int, torch.Tensor]  # (batch,) with per-sample stepping
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
        saveat=None,
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
        fusable = (MLPDynamics, AlternatingMLP)
        if fused and not (solver == "tsit5" and isinstance(dynamics, fusable)):
            raise ValueError("fused requires solver='tsit5' and MLPDynamics or "
                             "AlternatingMLP dynamics")
        if per_sample and fused:
            if not (per_sample == "batched" and isinstance(dynamics, MLPDynamics)):
                raise ValueError(
                    "fused per-sample stepping requires per_sample='batched' and "
                    "MLPDynamics dynamics (lane-wise fused sweep); construct with "
                    "fused=False otherwise")
            if fused not in (True, "step"):
                raise ValueError(
                    f"fused={fused!r} with per_sample: the per-sample engine runs the "
                    "lane-wise trial-step kernels; use fused=True or 'step'")
        if per_sample is True:
            raise NotImplementedError(
                "per_sample=True (the vmap engine) is not ported yet (ROADMAP.md queue 1 "
                "item 3); use per_sample='batched'")
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
        self.saveat = saveat
        self.fused = fused
        self.per_sample = per_sample
        self._names = [name for name, _ in dynamics.named_parameters()]

    def _func(self, t, y, leaves):
        # The solver hands the parameters in as ``leaves`` (the adjoint
        # differentiates with respect to them), in ``parameters()`` order.
        params = dict(zip(self._names, leaves))
        inputs = (y, t) if self.time_dep else (y,)
        return torch.func.functional_call(self.dynamics, params, inputs)

    def _step_sweeps(self):
        """The normed trial-step pair for ``odeint``: the kernels on
        ``fused``, their plain versions otherwise; None for dynamics
        without a hand-written step (the plain sweep over ``_func``)."""
        rtol, atol = self.rtol, self.atol
        if isinstance(self.dynamics, AlternatingMLP):
            from regneuralde_tpu_torch.ops import fused_generic as fg

            make = (fg.make_alternating_mlp_sweep if self.fused
                    else fg.make_plain_alternating_mlp_sweep)
            return make(rtol, atol)
        if isinstance(self.dynamics, MLPDynamics):
            from regneuralde_tpu_torch.ops import fused_mlp as fm

            fwd, bwd = ((fm.mlp_dynamics_normed_sweep, fm.mlp_dynamics_normed_sweep_bwd)
                        if self.fused else
                        (fm.plain_mlp_normed_sweep, fm.plain_mlp_normed_sweep_bwd))
            return (lambda t, dt, y, f0, p: fwd(t, dt, y, f0, p, rtol, atol),
                    lambda t, dt, y, k1, p, cts: bwd(t, dt, y, k1, p, cts, rtol, atol))
        return None, None

    def _lane_sweeps(self):
        """The lane-wise trial-step pair of the per-sample engine: K11/K12 on
        ``fused``, their plain versions otherwise, for MLPDynamics; None
        (the traced sweep over ``_func``) for other dynamics."""
        if not isinstance(self.dynamics, MLPDynamics):
            return None, None
        from regneuralde_tpu_torch.ops import fused_mlp_lanes as fl

        if self.fused:
            return fl.mlp_dynamics_sweep_lanes, fl.mlp_dynamics_sweep_lanes_bwd
        return fl.plain_mlp_sweep_lanes, fl.plain_mlp_sweep_lanes_bwd

    def forward(self, x: torch.Tensor, *, tspan: Optional[Tuple] = None,
                saveat=None, mode: str = "adjoint") -> NeuralDEOutput:
        """``tspan``'s ``t0``/``t1`` may be ``(batch,)`` vectors on a
        per-sample node (per-sample STEER)."""
        t0, t1 = tspan if tspan is not None else self.tspan
        saveat = saveat if saveat is not None else self.saveat
        leaves = tuple(self.dynamics.parameters())
        # the kernels take contiguous rows; a caller may hand in a column
        # slice (the latent model's mu0)
        x = x.contiguous()
        if self.per_sample:
            from regneuralde_tpu_torch.ops.per_sample import odeint_per_sample

            sweep, sweep_bwd = self._lane_sweeps()
            sol = odeint_per_sample(
                self._func, x, t0, t1, leaves, engine="batched", solver=self.solver,
                rtol=self.rtol, atol=self.atol, max_steps=self.max_steps, saveat=saveat,
                mode=mode, stage_sweep_lanes=sweep, stage_sweep_lanes_bwd=sweep_bwd)
        elif self.fused in _WHOLE_SOLVE and mode == "adjoint":
            if self.fused == "tiled" and saveat is not None:
                raise ValueError(
                    "fused='tiled' supports final-state solves only "
                    "(saveat must be None); use fused=True or 'solve'")
            from regneuralde_tpu_torch.ops.whole_solve import whole_solve_odeint

            sol = whole_solve_odeint(
                self._func, x, t0, t1, leaves, rtol=self.rtol, atol=self.atol,
                max_steps=self.max_steps, saveat=saveat,
                dynamics="mlp" if isinstance(self.dynamics, MLPDynamics) else "altmlp")
        else:
            stage_sweep, stage_sweep_bwd = (self._step_sweeps() if self.solver == "tsit5"
                                            else (None, None))
            sol = odeint(
                self._func, x, t0, t1, leaves,
                solver=self.solver,
                rtol=self.rtol, atol=self.atol, max_steps=self.max_steps,
                mode=mode, stage_sweep=stage_sweep, stage_sweep_bwd=stage_sweep_bwd,
                saveat=saveat,
            )
        # (time, batch, feat) -> (batch, time, feat)
        value = sol.y1 if saveat is None else sol.ys.transpose(0, 1)
        return NeuralDEOutput(value=value, nfe=sol.stats.nfe,
                              telemetry=sol.telemetry, solution=sol)
