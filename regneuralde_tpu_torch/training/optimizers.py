"""Optimizer chains in Flux order (counterpart of
``regneuralde_tpu/training/optimizers.py``).

Flux applies a chain left to right: ``Optimiser(InvDecay(g), Momentum(lr,
rho))`` first scales the gradient by ``1 / (1 + g n)``, with n counting
steps from 0, then applies momentum ``v = rho v + lr g; p -= v``. That is
not ``torch.optim.SGD`` (which folds lr in after the momentum), so the
chain is written by hand, with the optax-style ``init``/``update`` pair
the JAX package uses; ``update(grads, state, params)`` takes the
parameters as optax's does (``WeightDecay`` reads them).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Tensors = List[torch.Tensor]


class InvDecay:
    """Multiply the update by ``1 / (1 + gamma * n)``; n counts steps."""

    def __init__(self, gamma: float):
        self.gamma = gamma

    def init(self, params: Sequence[torch.Tensor]):
        return torch.zeros((), dtype=torch.int64)

    def update(self, grads: Tensors, count, params=None) -> Tuple[Tensors, torch.Tensor]:
        # float32 on the host (the count lives there), handed to the
        # products as a Python float: no copy to the device per parameter
        scale = (1.0 / (1.0 + self.gamma * count.to(torch.float32))).item()
        return [g * scale for g in grads], count + 1


class Momentum:
    """Flux ``Momentum(lr, rho)``: ``v = rho v + lr g``; the update is ``-v``."""

    def __init__(self, lr: float, rho: float = 0.9):
        self.lr, self.rho = lr, rho

    def init(self, params: Sequence[torch.Tensor]):
        return [torch.zeros_like(p) for p in params]

    def update(self, grads: Tensors, velocity: Tensors, params=None
               ) -> Tuple[Tensors, Tensors]:
        velocity = [self.rho * v + self.lr * g for v, g in zip(velocity, grads)]
        return [-v for v in velocity], velocity


class AdaMax:
    """optax's ``adamax(lr)`` (the latent ODE's ``AdaMax(0.01)``; Flux's
    differs in where eps goes, and the JAX package trains with optax's):
    ``mu = (1 - b1) g + b1 mu``, ``nu = max(|g| + eps, b2 nu)``, and the
    update ``-lr * (mu / (1 - b1^n)) / nu`` with n counting steps from 1."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]):
        return (torch.zeros((), dtype=torch.int32),
                [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def update(self, grads: Tensors, state, params=None) -> Tuple[Tensors, tuple]:
        count, mu, nu = state
        count = count + 1
        mu = [(1 - self.b1) * g + self.b1 * m for g, m in zip(grads, mu)]
        nu = [torch.maximum(torch.abs(g) + self.eps, self.b2 * v)
              for g, v in zip(grads, nu)]
        # the bias correction in float32 as optax computes it, on the host
        correction = (1 - torch.tensor(self.b1, dtype=torch.float32) ** count).item()
        updates = [-self.lr * ((m / correction) / v) for m, v in zip(mu, nu)]
        return updates, (count, mu, nu)


class Adam:
    """optax's ``adam(lr)`` (FFJORD's ``ADAM``): ``mu = (1 - b1) g + b1 mu``,
    ``nu = (1 - b2) g^2 + b2 nu``, and the update ``-lr * mu_hat /
    (sqrt(nu_hat) + eps)`` with the bias corrections ``mu_hat = mu / (1 -
    b1^n)``, ``nu_hat = nu / (1 - b2^n)``, n counting steps from 1."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]):
        return (torch.zeros((), dtype=torch.int32),
                [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def update(self, grads: Tensors, state, params=None) -> Tuple[Tensors, tuple]:
        count, mu, nu = state
        count = count + 1
        mu = [(1 - self.b1) * g + self.b1 * m for g, m in zip(grads, mu)]
        nu = [(1 - self.b2) * torch.square(g) + self.b2 * v for g, v in zip(grads, nu)]
        # the bias corrections in float32 as optax computes them, on the host
        c1, c2 = ((1 - torch.tensor(b, dtype=torch.float32) ** count).item()
                  for b in (self.b1, self.b2))
        updates = [-self.lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps))
                   for m, v in zip(mu, nu)]
        return updates, (count, mu, nu)


class AdaBelief:
    """optax's ``adabelief(lr)`` (the toy SDE's ``AdaBelief(0.01)``): ``mu =
    (1 - b1) g + b1 mu``, ``nu = (1 - b2) (g - mu)^2 + b2 nu + eps_root``,
    and the update ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` with the bias
    corrections ``mu_hat = mu / (1 - b1^n)``, ``nu_hat = nu / (1 - b2^n)``,
    n counting steps from 1; optax's defaults ``eps = eps_root = 1e-16``."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-16, eps_root: float = 1e-16):
        self.lr, self.b1, self.b2, self.eps, self.eps_root = lr, b1, b2, eps, eps_root

    def init(self, params: Sequence[torch.Tensor]):
        return (torch.zeros((), dtype=torch.int32),
                [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def update(self, grads: Tensors, state, params=None) -> Tuple[Tensors, tuple]:
        count, mu, nu = state
        count = count + 1
        mu = [(1 - self.b1) * g + self.b1 * m for g, m in zip(grads, mu)]
        nu = [(1 - self.b2) * torch.square(g - m) + self.b2 * v + self.eps_root
              for g, m, v in zip(grads, mu, nu)]
        # the bias corrections in float32 as optax computes them, on the host
        c1, c2 = ((1 - torch.tensor(b, dtype=torch.float32) ** count).item()
                  for b in (self.b1, self.b2))
        updates = [-self.lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps))
                   for m, v in zip(mu, nu)]
        return updates, (count, mu, nu)


class WeightDecay:
    """optax's ``add_decayed_weights(wd)`` (Flux's ``WeightDecay``): adds
    ``wd * p`` to the update of each parameter ``p``."""

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]):
        return ()

    def update(self, grads: Tensors, state, params) -> Tuple[Tensors, tuple]:
        return [g + self.weight_decay * p.detach() for g, p in zip(grads, params)], state


class Chain:
    """Apply transformations left to right."""

    def __init__(self, *parts):
        self.parts = parts

    def init(self, params: Sequence[torch.Tensor]):
        return tuple(p.init(params) for p in self.parts)

    def update(self, grads: Tensors, state, params=None):
        new_state = []
        for part, s in zip(self.parts, state):
            grads, s = part.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor], updates: Tensors) -> None:
    """``p += u`` in place (the port may update parameters in place; the
    JAX package builds new arrays)."""
    for p, u in zip(params, updates):
        p.add_(u)


def mnist_node_optimizer() -> Chain:
    """InvDecay(1e-5) then Momentum(0.1, 0.9) (experiments/mnist_node.jl:130)."""
    return Chain(InvDecay(1e-5), Momentum(0.1, 0.9))


def latent_ode_optimizer() -> Chain:
    """InvDecay(1e-5) then AdaMax(0.01) (experiments/latent_ode.jl:108)."""
    return Chain(InvDecay(1e-5), AdaMax(0.01))


def mnist_nsde_optimizer() -> Chain:
    """InvDecay(1e-5) then ADAM(0.01) (experiments/mnist_nsde.jl)."""
    return Chain(InvDecay(1e-5), Adam(0.01))


def ffjord_optimizer(lr: float = 1e-2) -> Chain:
    """WeightDecay(1e-5) then ADAM(lr) (experiments/ffjord_tabular.jl:133)."""
    return Chain(WeightDecay(1e-5), Adam(lr))


def sde_toy_optimizer() -> AdaBelief:
    """AdaBelief(0.01) (experiments/sde_toy_problem.jl:65)."""
    return AdaBelief(0.01)
