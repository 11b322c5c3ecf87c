"""Dynamics networks and small building blocks (counterpart of
``regneuralde_tpu/models/basic.py``).

Layers carry flax's names (``dense_i``, ``up_i``/``down_i``,
``update_gate``/``reset_gate``/``new_state``), so ``convert.py`` maps a
JAX parameter tree onto the ``state_dict`` name for name. Weights are drawn
from an explicit ``torch.Generator``. Every module is placed on the card
(``device="cuda"``) unless the caller asks for the CPU with
``device="cpu"``; without a CUDA device the default raises.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from regneuralde_tpu_torch.ops.math import sigmoid, softplus, tanh


def init_linear(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """LeCun-normal weights (std 1/sqrt(fan_in)) and zero biases, the scale
    of flax's ``Dense`` default, drawn from ``generator``."""
    with torch.no_grad():
        w = torch.randn(layer.weight.shape, generator=generator,
                        dtype=layer.weight.dtype)
        layer.weight.copy_(w / math.sqrt(layer.in_features))
        layer.bias.zero_()


def place(module: nn.Module, device) -> None:
    """Moves ``module`` to ``device``; a CUDA device that is missing raises
    rather than leaving the module on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the model "
                           "on the CPU")
    module.to(device)


def _t_col(x: torch.Tensor, t) -> torch.Tensor:
    """The solve time as a ``(batch, 1)`` column for concatenation: a
    scalar is broadcast to every row, a ``(batch,)`` vector (the per-sample
    engine advances every row at its own time) gives one entry a row."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    if t.dim() == 1:
        return t[:, None].expand(x.shape[0], 1)
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
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.hidden = dim, hidden
        self.dense_1 = nn.Linear(dim + 1, hidden)
        self.dense_2 = nn.Linear(hidden + 1, dim)
        init_linear(self.dense_1, generator)
        init_linear(self.dense_2, generator)
        place(self, device)

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        h = tanh(self.dense_1(torch.cat([x, _t_col(x, t)], dim=-1)))
        return tanh(self.dense_2(torch.cat([h, _t_col(h, t)], dim=-1)))


class MLP(nn.Module):
    """Plain Dense chain (no time input): ``activation`` between layers, the
    output layer linear unless ``final_activation`` is set. flax infers
    the input width; here it is ``in_features``."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = torch.tanh,
                 final_activation: Optional[Callable] = None, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation, self.final_activation = activation, final_activation
        self.n_layers = len(features)
        width = in_features
        for i, f in enumerate(features):
            layer = nn.Linear(width, f)
            init_linear(layer, generator)
            setattr(self, f"dense_{i}", layer)
            width = f
        place(self, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            h = getattr(self, f"dense_{i}")(h)
            if i < self.n_layers - 1:
                h = self.activation(h)
        if self.final_activation is not None:
            h = self.final_activation(h)
        return h


class AlternatingMLP(nn.Module):
    """tanh -> (Dense(d, h) tanh -> Dense(h, d) tanh) * depth: the latent-ODE
    generative dynamics. ``parameters()`` yields ``up_0.weight, up_0.bias,
    down_0.weight, down_0.bias, up_1.weight, ...``, the leaves the fused
    trial-step kernels take (``ops.fused_generic``). The tanh is
    ``torch.tanh``, the counterpart of the JAX module's ``jnp.tanh``."""

    def __init__(self, dim: int = 20, hidden: int = 50, depth: int = 4, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.hidden, self.depth = dim, hidden, depth
        for i in range(depth):
            up, down = nn.Linear(dim, hidden), nn.Linear(hidden, dim)
            init_linear(up, generator)
            init_linear(down, generator)
            setattr(self, f"up_{i}", up)
            setattr(self, f"down_{i}", down)
        place(self, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x)
        for i in range(self.depth):
            h = torch.tanh(getattr(self, f"up_{i}")(h))
            h = torch.tanh(getattr(self, f"down_{i}")(h))
        return h


class ConcatSquashLinear(nn.Module):
    """``(x W^T + b) * sigmoid(t w_g) + (t w_b + b_b)``: FFJORD's CSL layer.

    ``layer`` is ``nn.Linear(in, out)``, ``gate`` ``nn.Linear(1, out,
    bias=False)`` and ``bias`` ``nn.Linear(1, out)``, each over the scalar
    time, as flax's ``layer``, ``gate`` and ``bias`` Dense layers."""

    def __init__(self, in_features: int, features: int, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer = nn.Linear(in_features, features)
        self.gate = nn.Linear(1, features, bias=False)
        self.bias = nn.Linear(1, features)
        init_linear(self.layer, generator)
        init_linear(self.bias, generator)
        with torch.no_grad():  # LeCun-normal at fan_in 1
            self.gate.weight.copy_(torch.randn(self.gate.weight.shape, generator=generator))
        place(self, device)

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(1, 1)
        return self.layer(x) * sigmoid(self.gate(t)) + self.bias(t)


class CSLDynamics(nn.Module):
    """Three CSL layers (dim -> hidden -> hidden -> dim) with softplus
    between them: the FFJORD dynamics of the tabular and gaussian
    experiments. ``parameters()`` yields per layer ``layer.weight,
    layer.bias, gate.weight, bias.weight, bias.bias``, the leaves the CSL
    kernels take (``ops.fused_csl``). softplus and sigmoid are the
    ``ops.math`` forms, JAX's functions."""

    def __init__(self, dim: int, hidden: int = 100, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.hidden = dim, hidden
        self.csl1 = ConcatSquashLinear(dim, hidden, device=device, generator=generator)
        self.csl2 = ConcatSquashLinear(hidden, hidden, device=device, generator=generator)
        self.csl3 = ConcatSquashLinear(hidden, dim, device=device, generator=generator)
        place(self, device)

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        h = softplus(self.csl1(x, t))
        h = softplus(self.csl2(h, t))
        return self.csl3(h, t)

    def forw_n_back(self, x: torch.Tensor, t, e: torch.Tensor):
        """``(f(x, t), eJ)``: the forward value and the analytic ``e^T J``
        through the chain ``v -> v (W * gate)`` with ``sigmoid(o)`` (the
        softplus derivative) between the hops (``ops.fused_csl``, the
        kernels' algebra)."""
        from regneuralde_tpu_torch.ops.fused_csl import csl_forw_n_back

        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        return csl_forw_n_back(t, x, tuple(self.parameters()), e)


class _LatentGRUCell(nn.Module):
    """One masked GRU-Bayes update over ``x = [data, mask, delta_t]``."""

    def __init__(self, in_dim: int, hidden: int, latent_dim: int, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim, self.latent_dim = in_dim, latent_dim
        width = 2 * latent_dim + 2 * in_dim + 1
        self.update_gate = MLP(width, [hidden, latent_dim], torch.tanh, torch.sigmoid,
                               device=device, generator=generator)
        self.reset_gate = MLP(width, [hidden, latent_dim], torch.tanh, torch.sigmoid,
                              device=device, generator=generator)
        self.new_state = MLP(width, [hidden, 2 * latent_dim], torch.tanh,
                             device=device, generator=generator)

    def forward(self, y_mean, y_std, x):
        y_concat = torch.cat([y_mean, y_std, x], dim=-1)
        u = self.update_gate(y_concat)
        r = self.reset_gate(y_concat)
        ns = self.new_state(torch.cat([y_mean * r, y_std * r, x], dim=-1))
        n_mean, n_std = ns[:, :self.latent_dim], ns[:, self.latent_dim:]
        ym = (1 - u) * n_mean + u * y_mean
        ys = (1 - u) * n_std + u * y_std
        # an unobserved step (its mask block all zero) freezes the state
        mask = (torch.sum(x[:, self.in_dim:2 * self.in_dim], dim=-1, keepdim=True)
                > 0).to(x.dtype)
        return mask * ym + (1 - mask) * y_mean, mask * ys + (1 - mask) * y_std


class LatentGRU(nn.Module):
    """Masked GRU-Bayes cell over irregular series, run backwards in time.

    ``xs`` is ``(batch, time, 2 * in_dim + 1)``, each step ``[data, mask,
    delta_t]``; returns ``cat([y_mean, y_std])``, ``(batch, 2 *
    latent_dim)``. The JAX module scans the cell (``nn.scan``); here a
    Python loop over the reversed time axis runs it."""

    def __init__(self, in_dim: int, hidden: int, latent_dim: int, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.cell = _LatentGRUCell(in_dim, hidden, latent_dim, device=device,
                                   generator=generator)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        y_mean = y_std = xs.new_zeros((xs.shape[0], self.latent_dim))
        for i in range(xs.shape[1] - 1, -1, -1):
            y_mean, y_std = self.cell(y_mean, y_std, xs[:, i])
        return torch.cat([y_mean, y_std], dim=-1)
