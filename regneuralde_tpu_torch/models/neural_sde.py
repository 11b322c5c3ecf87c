"""NeuralSDE layer (counterpart of ``regneuralde_tpu/models/neural_sde.py``).

``du = f(u; p) dt + g(u; p) dW`` with diagonal noise, solved adaptively by
``ops.sde.sdeint`` (``fused=False``) or by the whole-solve kernels K9/K10
(``ops.sde_whole_solve``; ``fused=True`` or ``"solve"`` in
``mode="adjoint"`` with the collapse bridge) for the pairs they have a tile
body for, without time input: an ``MLP`` drift (body ``"mlp"``) or a
``CubicDrift`` (body ``"cubic"``, the toy 2-D SDE's), with an ``MLP``
diffusion. JAX's kernels take any pair; for a pair outside those two
``fused=True`` takes ``sdeint`` and ``"solve"`` raises ``ValueError``. The
Hopper kernels mask a ragged row tile and keep the history in global
memory, so there is no VMEM gate: every batch size of an eligible pair
takes the kernels (JAX sends a ``fused=True`` solve past its VMEM estimate
to ``sdeint``).

The draws are explicit (the port has no global RNG): ``noise=(xi_w,
xi_z)``, each ``(max_steps,) + x.shape``, or a ``torch.Generator``
(``ops.sde.presample_noise``). Not ported yet, raising
``NotImplementedError`` naming ``ROADMAP.md``: per-sample stepping.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from regneuralde_tpu_torch.models.basic import MLP, init_linear, place
from regneuralde_tpu_torch.ops.ode import StepTelemetry
from regneuralde_tpu_torch.ops.sde import SDESolution, sdeint
from regneuralde_tpu_torch.ops.sde_whole_solve import MAX_LAYERS


class NeuralSDEOutput(NamedTuple):
    value: torch.Tensor  # the final state, or (batch, time, feat) at saveat
    nfe1: int  # drift evaluations
    nfe2: int  # diffusion evaluations
    telemetry: StepTelemetry
    solution: SDESolution


class CubicDrift(nn.Module):
    """The toy 2-D SDE's drift (``experiments/sde_toy.py:30-37``): ``x -> x *
    x * x -> dense_0 (dim -> hidden) -> tanh -> dense_1 (hidden -> dim)``.
    The cube is two products, as XLA computes ``x**3``."""

    n_layers = 2  # the layers of its MLP: the leaves the SDE kernels take

    def __init__(self, dim: int = 2, hidden: int = 50, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.hidden = dim, hidden
        self.dense_0 = nn.Linear(dim, hidden)
        self.dense_1 = nn.Linear(hidden, dim)
        init_linear(self.dense_0, generator)
        init_linear(self.dense_1, generator)
        place(self, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_1(torch.tanh(self.dense_0(x * x * x)))


def _kernel_mlp(m: nn.Module, width: int) -> bool:
    """An ``MLP`` the SDE kernels run: tanh between layers, a linear last
    layer, at most MAX_LAYERS layers, from and to the state's width."""
    return (isinstance(m, MLP) and m.activation is torch.tanh and m.final_activation is None
            and 1 <= m.n_layers <= MAX_LAYERS
            and m.dense_0.in_features == width
            and getattr(m, f"dense_{m.n_layers - 1}").out_features == width)


class NeuralSDE(nn.Module):
    """du = f(u; p) dt + g(u; p) dW (diagonal noise), solved adaptively.
    ``parameters()`` yields the drift's, then the diffusion's."""

    def __init__(
        self,
        drift: nn.Module,
        diffusion: nn.Module,
        tspan: Tuple[float, float] = (0.0, 1.0),
        time_dep: bool = False,
        solver: str = "sosri",
        rtol: float = 1.4e-1,
        atol: float = 1.4e-1,
        max_steps: int = 256,
        saveat=None,
        fused=False,
        per_sample=False,
    ):
        super().__init__()
        if fused not in (False, True, "solve"):
            raise ValueError("fused must be False, True or 'solve'")
        if per_sample not in (False, True, "batched"):
            raise ValueError(f"per_sample must be False, True or 'batched', got {per_sample!r}")
        if per_sample and fused:
            raise ValueError("per_sample adaptive stepping is incompatible with fused kernels "
                             "— construct with fused=False")
        if per_sample:
            raise NotImplementedError(
                f"per_sample={per_sample!r}: the per-sample SDE engines are not ported yet "
                "(ROADMAP.md queue 1)")
        self.drift = drift
        self.diffusion = diffusion
        self.tspan = tspan
        self.time_dep = time_dep
        self.solver = solver
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.saveat = saveat
        self.fused = fused
        self._n_drift = len(list(drift.parameters()))
        self._names = ([n for n, _ in drift.named_parameters()],
                       [n for n, _ in diffusion.named_parameters()])

    def _call(self, k, t, y, leaves):
        # the solver hands the parameters in as leaves (the adjoint
        # differentiates with respect to them)
        module = (self.drift, self.diffusion)[k]
        part = leaves[:self._n_drift] if k == 0 else leaves[self._n_drift:]
        inputs = (y, t) if self.time_dep else (y,)
        return torch.func.functional_call(module, dict(zip(self._names[k], part)), inputs)

    def _drift(self, t, y, leaves):
        return self._call(0, t, y, leaves)

    def _diffusion(self, t, y, leaves):
        return self._call(1, t, y, leaves)

    def kernel_body(self, x: torch.Tensor) -> Optional[str]:
        """The whole-solve kernels' tile body for this pair on ``x``
        (``"mlp"`` or ``"cubic"``), or None: no time input, a 2-D float32
        state, an MLP diffusion (``_kernel_mlp``) and an MLP or
        ``CubicDrift`` drift, from and to the state's width."""
        width = x.shape[-1]
        if (self.time_dep or x.dim() != 2 or x.dtype != torch.float32
                or not _kernel_mlp(self.diffusion, width)
                or any(p.dtype != torch.float32 for p in self.parameters())):
            return None
        if isinstance(self.drift, CubicDrift) and self.drift.dim == width:
            return "cubic"
        return "mlp" if _kernel_mlp(self.drift, width) else None

    def forward(self, x: torch.Tensor, *, noise=None, generator: Optional[torch.Generator] = None,
                tspan: Optional[Tuple] = None, saveat=None, mode: str = "adjoint",
                brownian: str = "collapse") -> NeuralSDEOutput:
        t0, t1 = tspan if tspan is not None else self.tspan
        saveat = saveat if saveat is not None else self.saveat
        leaves = tuple(self.parameters())
        x = x.contiguous()
        kw = dict(noise=noise, generator=generator, solver=self.solver, rtol=self.rtol,
                  atol=self.atol, max_steps=self.max_steps, saveat=saveat)
        sol = None
        if self.fused and mode == "adjoint" and self.solver != "em" and brownian == "collapse":
            body = self.kernel_body(x)
            if self.fused == "solve" and body is None:
                raise ValueError("fused='solve' needs a 2-D float32 state, an MLP or CubicDrift "
                                 "drift and an MLP diffusion (tanh between layers, linear out, "
                                 "no time input)")
            if body is not None:
                from regneuralde_tpu_torch.ops.sde_whole_solve import whole_solve_sdeint

                sol = whole_solve_sdeint(x, t0, t1, leaves, n_drift=self.drift.n_layers,
                                         body=body, **kw)
        if sol is None:
            sol = sdeint(self._drift, self._diffusion, x, t0, t1, leaves, mode=mode,
                         brownian=brownian, **kw)
        value = sol.y1 if saveat is None else sol.ys.transpose(0, 1)
        return NeuralSDEOutput(value=value, nfe1=sol.stats.nfe1, nfe2=sol.stats.nfe2,
                               telemetry=sol.telemetry, solution=sol)
