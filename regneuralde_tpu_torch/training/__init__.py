"""Training harness: train state and an eager train step.

Counterpart of ``regneuralde_tpu/training/__init__.py``. The JAX package
jit-compiles the step; PyTorch runs it eagerly: forward, loss,
``backward``, optimizer update.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from regneuralde_tpu_torch.training.optimizers import (
    Chain,
    InvDecay,
    Momentum,
    apply_updates,
    mnist_node_optimizer,
)


class TrainState(NamedTuple):
    model: nn.Module
    opt_state: Any
    step: int


def create_train_state(model: nn.Module, optimizer) -> TrainState:
    return TrainState(model=model, opt_state=optimizer.init(list(model.parameters())),
                      step=0)


def make_train_step(loss_fn: Callable, optimizer) -> Callable:
    """``(state, *batch) -> (state, loss, aux)``. ``loss_fn(model, *batch)``
    returns ``(loss, aux)``. The model's parameters are updated in place."""

    def step(state: TrainState, *batch):
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        loss, aux = loss_fn(state.model, *batch)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        updates, opt_state = optimizer.update(grads, state.opt_state)
        apply_updates(params, updates)
        return TrainState(state.model, opt_state, state.step + 1), loss.detach(), aux

    return step


__all__ = ["Chain", "InvDecay", "Momentum", "TrainState", "apply_updates",
           "create_train_state", "make_train_step", "mnist_node_optimizer"]
