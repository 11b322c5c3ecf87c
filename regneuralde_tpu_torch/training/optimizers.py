"""Optimizer chains in Flux order (counterpart of
``regneuralde_tpu/training/optimizers.py``).

Flux applies a chain left to right: ``Optimiser(InvDecay(g), Momentum(lr,
rho))`` first scales the gradient by ``1 / (1 + g n)``, with n counting
steps from 0, then applies momentum ``v = rho v + lr g; p -= v``. That is
not ``torch.optim.SGD`` (which folds lr in after the momentum), so the
chain is written by hand, with the optax-style ``init``/``update`` pair
the JAX package uses.
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

    def update(self, grads: Tensors, count) -> Tuple[Tensors, torch.Tensor]:
        scale = 1.0 / (1.0 + self.gamma * count.to(torch.float32))
        return [g * scale.to(g.device) for g in grads], count + 1


class Momentum:
    """Flux ``Momentum(lr, rho)``: ``v = rho v + lr g``; the update is ``-v``."""

    def __init__(self, lr: float, rho: float = 0.9):
        self.lr, self.rho = lr, rho

    def init(self, params: Sequence[torch.Tensor]):
        return [torch.zeros_like(p) for p in params]

    def update(self, grads: Tensors, velocity: Tensors) -> Tuple[Tensors, Tensors]:
        velocity = [self.rho * v + self.lr * g for v, g in zip(velocity, grads)]
        return [-v for v in velocity], velocity


class Chain:
    """Apply transformations left to right."""

    def __init__(self, *parts):
        self.parts = parts

    def init(self, params: Sequence[torch.Tensor]):
        return tuple(p.init(params) for p in self.parts)

    def update(self, grads: Tensors, state):
        new_state = []
        for part, s in zip(self.parts, state):
            grads, s = part.update(grads, s)
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
