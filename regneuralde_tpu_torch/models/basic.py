"""Dynamics networks (counterpart of ``regneuralde_tpu/models/basic.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from regneuralde_tpu_torch.ops.math import tanh


def init_linear(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """LeCun-normal weights (std 1/sqrt(fan_in)) and zero biases, the scale
    of flax's ``Dense`` default, drawn from ``generator``."""
    with torch.no_grad():
        w = torch.randn(layer.weight.shape, generator=generator,
                        dtype=layer.weight.dtype)
        layer.weight.copy_(w / math.sqrt(layer.in_features))
        layer.bias.zero_()


def _t_col(x: torch.Tensor, t) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    return t.reshape(1, 1).expand(x.shape[0], 1)


class MLPDynamics(nn.Module):
    """The MNIST Neural-ODE dynamics: D -(+t)-> H tanh -(+t)-> D tanh.

    ``dense_1`` is ``nn.Linear(D+1, H)`` and ``dense_2`` is
    ``nn.Linear(H+1, D)``, each over ``cat([x, t])``, so the time column of
    each weight is its last one. ``parameters()`` yields ``(W1, b1, W2,
    b2)``, the layout the fused kernels take. The tanh is the accurate
    ``ops.math`` form.
    """

    def __init__(self, dim: int = 784, hidden: int = 100, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.hidden = dim, hidden
        self.dense_1 = nn.Linear(dim + 1, hidden)
        self.dense_2 = nn.Linear(hidden + 1, dim)
        init_linear(self.dense_1, generator)
        init_linear(self.dense_2, generator)
        self.to(device)

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        h = tanh(self.dense_1(torch.cat([x, _t_col(x, t)], dim=-1)))
        return tanh(self.dense_2(torch.cat([h, _t_col(h, t)], dim=-1)))
