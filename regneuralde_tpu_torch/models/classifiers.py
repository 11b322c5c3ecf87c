"""Composite classifier (counterpart of ``regneuralde_tpu/models/classifiers.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from regneuralde_tpu_torch.models.basic import init_linear
from regneuralde_tpu_torch.models.neural_ode import NeuralODE
from regneuralde_tpu_torch.ops.ode import StepTelemetry


class ClassifierNODEOutput(NamedTuple):
    logits: torch.Tensor
    nfe: int
    telemetry: StepTelemetry
    success: bool  # the solver reached t1 within max_steps


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
        h = self.pre(x) if self.pre is not None else x
        out = self.node(h, **node_kwargs)
        return ClassifierNODEOutput(
            logits=self.post(out.value), nfe=out.nfe, telemetry=out.telemetry,
            success=out.solution.stats.success)
