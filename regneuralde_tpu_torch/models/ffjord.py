"""FFJORD continuous normalizing flow (counterpart of
``regneuralde_tpu/models/ffjord.py``).

The same model as the JAX package's ``FFJORD``:

* the Hutchinson trace estimator with one probe ``e ~ N(0, I)`` per solve,
  drawn from an explicit ``torch.Generator`` or passed in (``e=``); the
  ``e^T J`` product comes from ``CSLDynamics.forw_n_back`` (the analytic
  form, ``analytic_vjp=True``) or from ``torch.func.vjp``;
* the augmented state ``[z; logp]``, extended with the RNODE kinetic terms
  ``[..; int |f|^2; int |e^T J|^2]`` with ``kinetic_reg``;
* ``logpx = logpz - delta_logp`` under a standard normal; the solver's
  telemetry is always returned;
* ``sample`` integrates in reverse time with the exact trace (a batched
  Jacobian by ``torch.func``) in ``mode="while"``, with no kernel.

Routes, for ``CSLDynamics`` with the analytic product (as in JAX):

* ``fused=True`` and ``"solve"`` in ``mode="adjoint"``: the whole solve,
  one kernel per direction (``ops.whole_solve`` with ``dynamics="csl"``,
  K3/K4 with the CSL tile bodies);
* ``fused="step"``, and ``True``/``"solve"`` in ``mode="while"``: one CSL
  trial-step kernel pair per trial step under the fast adjoint
  (``ops.fused_csl``, K7/K8-CSL);
* ``fused=False``: the same fast adjoint over the kernels' plain versions
  (the same algebra, so the routes differ only by rounding); any other
  dynamics take the plain normed sweep with its autograd reverse.

JAX sends ``fused=True`` to the whole solve only below a VMEM estimate and
misaligned batches (``batch % 8``) to the unfused engine. The Hopper kernels
mask a ragged row tile and keep the batch in global memory, so the port has
neither gate: ``fused=True`` takes the whole solve at every batch size.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from regneuralde_tpu_torch.models.basic import CSLDynamics
from regneuralde_tpu_torch.ops import fused_csl as fc
from regneuralde_tpu_torch.ops.ode import ODESolution, StepTelemetry, odeint


class FFJORDOutput(NamedTuple):
    """The reference's ``(logpx, lambda1, lambda2, nfe, sv)``."""

    logpx: torch.Tensor  # (batch,)
    kinetic: torch.Tensor  # int |f|^2 per sample (zeros unless kinetic_reg)
    jacobian: torch.Tensor  # int |e^T J|^2 per sample (zeros unless kinetic_reg)
    nfe: int
    telemetry: StepTelemetry
    solution: ODESolution


class FFJORD(nn.Module):
    def __init__(
        self,
        dynamics: nn.Module,
        input_dim: int,
        tspan: Tuple[float, float] = (0.0, 1.0),
        solver: str = "tsit5",
        rtol: float = 1.4e-8,
        atol: float = 1.4e-8,
        max_steps: int = 256,
        analytic_vjp: bool = True,
        fused=False,
    ):
        """``dynamics`` is called as ``m(z, t)``. With ``analytic_vjp`` a
        ``CSLDynamics`` gives ``e^T J`` by its ``forw_n_back``; otherwise
        ``torch.func.vjp`` does. ``fused`` (``True``, ``"step"`` or
        ``"solve"``) needs Tsit5, ``CSLDynamics`` and the analytic product."""
        super().__init__()
        self.analytic_vjp = analytic_vjp and hasattr(dynamics, "forw_n_back")
        if fused not in (False, True, "step", "solve"):
            raise ValueError("fused must be False, True, 'step' or 'solve'")
        if fused and not (solver == "tsit5" and isinstance(dynamics, CSLDynamics)
                          and self.analytic_vjp):
            raise ValueError("fused requires solver='tsit5', CSLDynamics dynamics, "
                             "and analytic_vjp")
        if self.analytic_vjp and not isinstance(dynamics, CSLDynamics):
            raise NotImplementedError(
                "the analytic e^T J of dynamics other than CSLDynamics is not "
                "ported; pass analytic_vjp=False")
        self.dynamics = dynamics
        self.input_dim = input_dim
        self.tspan = tspan
        self.solver = solver
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.fused = fused
        self._names = [name for name, _ in dynamics.named_parameters()]

    def _aug_dynamics(self, kinetic_reg: bool):
        """``f(t, u, leaves)`` of the augmented state over the dynamics'
        parameters and the probe (the last leaf)."""
        d = self.input_dim
        if self.analytic_vjp:
            return fc.csl_aug_apply(d, kinetic_reg)

        def func(t, u, leaves):
            params = dict(zip(self._names, leaves[:-1]))
            e = leaves[-1]
            mz, vjp_fn = torch.func.vjp(
                lambda z: torch.func.functional_call(self.dynamics, params, (z, t)),
                u[:, :d])
            return fc.aug_out(mz, vjp_fn(e)[0], e, kinetic_reg)

        return func

    def _step_sweeps(self):
        """The normed trial-step pair for ``odeint``: the CSL kernels on
        ``fused``, their plain versions for ``CSLDynamics`` otherwise, None
        for other dynamics (the plain sweep over ``_aug_dynamics``)."""
        if self.fused:
            return fc.make_csl_ffjord_sweep(self.rtol, self.atol)
        if self.analytic_vjp:
            return fc.make_plain_csl_sweep(self.rtol, self.atol)
        return None, None

    def forward(self, x: torch.Tensor, *, e: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, kinetic_reg: bool = False,
                mode: str = "adjoint") -> FFJORDOutput:
        """``logpx`` of the rows of ``x``; the probe ``e`` is drawn from
        ``generator`` unless given."""
        x = x.contiguous()
        batch = x.shape[0]
        if e is None:
            e = torch.randn(tuple(x.shape), generator=generator, dtype=x.dtype).to(x.device)
        n_aux = 3 if kinetic_reg else 1
        u0 = torch.cat([x, x.new_zeros((batch, n_aux))], dim=-1)
        leaves = fc.csl_aug_leaves(self.dynamics, e.contiguous())
        func = self._aug_dynamics(kinetic_reg)
        t0, t1 = self.tspan
        if self.fused in (True, "solve") and mode == "adjoint":
            from regneuralde_tpu_torch.ops.whole_solve import whole_solve_odeint

            sol = whole_solve_odeint(func, u0, t0, t1, leaves, rtol=self.rtol,
                                     atol=self.atol, max_steps=self.max_steps,
                                     dynamics="csl")
        else:
            stage_sweep, stage_sweep_bwd = (self._step_sweeps() if self.solver == "tsit5"
                                            else (None, None))
            sol = odeint(func, u0, t0, t1, leaves, solver=self.solver, rtol=self.rtol,
                         atol=self.atol, max_steps=self.max_steps, mode=mode,
                         stage_sweep=stage_sweep, stage_sweep_bwd=stage_sweep_bwd)
        return self._finish(sol, x, kinetic_reg)

    def _finish(self, sol: ODESolution, x, kinetic_reg: bool) -> FFJORDOutput:
        d = self.input_dim
        pred = sol.y1
        z = pred[:, :d]
        delta_logp = pred[:, d]
        if kinetic_reg:
            kinetic, jacobian = pred[:, d + 1], pred[:, d + 2]
        else:
            kinetic = jacobian = x.new_zeros((x.shape[0],))
        logpz = torch.sum(-(math.log(2 * math.pi) + torch.square(z)) / 2.0, dim=-1)
        return FFJORDOutput(logpx=logpz - delta_logp, kinetic=kinetic, jacobian=jacobian,
                            nfe=sol.stats.nfe, telemetry=sol.telemetry, solution=sol)

    def _exact_trace_dynamics(self):
        d = self.input_dim

        def func(t, u, _):
            z = u[:, :d]
            single = lambda zi: self.dynamics(zi[None, :], t)[0]
            jac = torch.func.vmap(torch.func.jacfwd(single))(z)  # (batch, d, d)
            trace = jac.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True)
            return torch.cat([self.dynamics(z, t), -trace], dim=-1)

        return func

    def sample(self, nsamples: int, *, generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None, mode: str = "while") -> torch.Tensor:
        """Samples: base-space noise (``z``, or drawn from ``generator``)
        integrated backwards through the flow with the exact trace."""
        if z is None:
            param = next(self.dynamics.parameters())
            z = torch.randn((nsamples, self.input_dim), generator=generator,
                            dtype=param.dtype).to(param.device)
        u0 = torch.cat([z, z.new_zeros((z.shape[0], 1))], dim=-1)
        sol = odeint(self._exact_trace_dynamics(), u0, self.tspan[1], self.tspan[0], (),
                     solver=self.solver, rtol=self.rtol, atol=self.atol,
                     max_steps=self.max_steps, mode=mode)
        return sol.y1[:, :self.input_dim]
