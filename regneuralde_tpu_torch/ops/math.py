"""Accuracy-critical elementwise math (counterpart of ``regneuralde_tpu/ops/math.py``).

The solver's embedded error estimate is a fifth-order cancellation, so the
dynamics' tanh must be accurate to f32 rounding: an approximate tanh sets
the floor of the error estimate and the controller shrinks dt to it. The
CUDA kernels use the same ``2 * sigmoid(2x) - 1`` form with ``expf``.
"""

from __future__ import annotations

import torch


def tanh(x: torch.Tensor) -> torch.Tensor:
    """Accurate tanh: ``2 * sigmoid(2x) - 1`` (exact derivative everywhere)."""
    return 2.0 * torch.sigmoid(2.0 * x) - 1.0
