"""Accuracy-critical elementwise math (counterpart of ``regneuralde_tpu/ops/math.py``).

The solver's embedded error estimate is a fifth-order cancellation, so the
dynamics' tanh must be accurate to f32 rounding: an approximate tanh sets
the floor of the error estimate and the controller shrinks dt to it. The
CUDA kernels use the same ``2 * sigmoid(2x) - 1`` form with ``expf``.

``sigmoid`` and ``softplus`` are written out op by op, so that a CUDA kernel
can round each step as these ATen ops do on the card (``expf``, ``log1pf``,
an IEEE divide): FFJORD's CSL kernels reproduce their plain versions
bitwise.
"""

from __future__ import annotations

import torch


def tanh(x: torch.Tensor) -> torch.Tensor:
    """Accurate tanh: ``2 * sigmoid(2x) - 1`` (exact derivative everywhere)."""
    return 2.0 * torch.sigmoid(2.0 * x) - 1.0


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, each op rounded on its own (``jax.nn.sigmoid``'s
    function; the CSL kernels' ``csl_sigmoid``)."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``.

    ATen's ``F.softplus`` returns ``x`` above a threshold of 20 and computes
    ``log1p(exp(x))`` below it: another function in float32."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
