"""Composite classifiers (counterpart of ``regneuralde_tpu/models/classifiers.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from regneuralde_tpu_torch.models.basic import init_linear
from regneuralde_tpu_torch.models.neural_ode import NeuralODE
from regneuralde_tpu_torch.models.neural_sde import NeuralSDE
from regneuralde_tpu_torch.ops.ode import StepTelemetry


class ClassifierNODEOutput(NamedTuple):
    logits: torch.Tensor
    nfe: Union[int, torch.Tensor]  # (batch,) with per-sample stepping
    telemetry: StepTelemetry
    success: Union[bool, torch.Tensor]  # the solver reached t1 within max_steps


class ClassifierNODE(nn.Module):
    """pre-net -> NeuralODE -> post-net. ``post`` may be lazy
    (``nn.LazyLinear(10)``, the counterpart of flax's ``Dense(10)``):
    ``init`` sizes it by running the node once in ``"while"`` mode."""

    def __init__(self, pre: Optional[nn.Module], node: NeuralODE, post: nn.Module):
        super().__init__()
        self.pre = pre
        self.node = node
        self.post = post

    @torch.no_grad()
    def init(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> "ClassifierNODE":
        """Materialize the post-net on the node's output and draw its
        weights from ``generator``."""
        h = self.pre(x) if self.pre is not None else x
        out = self.node(h, mode="while")
        self.post(out.value)
        if isinstance(self.post, nn.Linear):
            init_linear(self.post, generator)
        return self

    def forward(self, x: torch.Tensor, **node_kwargs) -> ClassifierNODEOutput:
        """``node_kwargs`` go to ``NeuralODE.forward`` (``tspan``, whose
        ``t1`` may be a ``(batch,)`` vector on a per-sample node; ``mode``).
        With per-sample stepping ``nfe`` and ``success`` are ``(batch,)``."""
        h = self.pre(x) if self.pre is not None else x
        out = self.node(h, **node_kwargs)
        return ClassifierNODEOutput(
            logits=self.post(out.value), nfe=out.nfe, telemetry=out.telemetry,
            success=out.solution.stats.success)


class ClassifierNSDEOutput(NamedTuple):
    logits: torch.Tensor
    nfe1: int
    nfe2: int
    telemetry: StepTelemetry
    success: bool  # the solver reached t1 within max_steps


class ClassifierNSDE(nn.Module):
    """pre-net -> NeuralSDE -> post-net with Monte-Carlo trajectory fan-out:
    the batch is tiled ``trajectories`` times, solved as one SDE state, and
    the post-net's outputs are averaged over the trajectory axis. ``post``
    may be lazy (``nn.LazyLinear(10)``): ``init`` sizes it."""

    def __init__(self, pre: Optional[nn.Module], nsde: NeuralSDE, post: nn.Module):
        super().__init__()
        self.pre = pre
        self.nsde = nsde
        self.post = post

    @torch.no_grad()
    def init(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> "ClassifierNSDE":
        """Materialize the post-net on one ``"while"`` solve of the batch
        (zero draws: only the output's shape matters) and draw its weights
        from ``generator``."""
        h = self.pre(x) if self.pre is not None else x
        zeros = h.new_zeros((self.nsde.max_steps,) + tuple(h.shape))
        out = self.nsde(h, noise=(zeros, zeros), mode="while")
        self.post(out.value)
        if isinstance(self.post, nn.Linear):
            init_linear(self.post, generator)
        return self

    def forward(self, x: torch.Tensor, *, trajectories: int = 1, **nsde_kwargs
                ) -> ClassifierNSDEOutput:
        """``nsde_kwargs`` go to ``NeuralSDE.forward`` (``noise`` or
        ``generator``, ``mode``, ...); the draws cover the tiled batch."""
        bsize = x.shape[0]
        x = x.repeat((trajectories,) + (1,) * (x.dim() - 1))
        h = self.pre(x) if self.pre is not None else x
        out = self.nsde(h, **nsde_kwargs)
        z = self.post(out.value)
        z = z.reshape((trajectories, bsize) + tuple(z.shape[1:])).mean(0)
        return ClassifierNSDEOutput(logits=z, nfe1=out.nfe1, nfe2=out.nfe2,
                                    telemetry=out.telemetry,
                                    success=out.solution.stats.success)
