"""Error norms (counterpart of ``regneuralde_tpu/ops/norms.py``).

The whole minibatch is one ODE state with one global error norm, as in the
reference: ``sqrt(sum(x^2) / n)`` over every element.
"""

from __future__ import annotations

import torch


def hairer_norm(x: torch.Tensor) -> torch.Tensor:
    """Scaled RMS norm ``sqrt(sum(x^2) / n)``, zero-guarded so that its
    derivative at 0 is 0 and not ``0 * inf = nan``."""
    sumsq = torch.sum(torch.square(x))
    safe = torch.where(sumsq > 0, sumsq, torch.ones_like(sumsq))
    return torch.where(sumsq > 0, torch.sqrt(safe / x.numel()),
                       torch.zeros_like(sumsq))


def scaled_error(err, y0, y1, rtol, atol) -> torch.Tensor:
    """``err / (atol + max(|y0|, |y1|) * rtol)``. ``torch.maximum`` splits
    its cotangent in half on a tie, as ``jax.vjp`` does
    (``ops.ode._max_grad``)."""
    return err / (atol + torch.maximum(torch.abs(y0), torch.abs(y1)) * rtol)


def error_ratio(err, y0, y1, rtol, atol) -> torch.Tensor:
    """The tolerance-normalized error estimate ``EEst =
    hairer_norm(scaled_error)``; a step is accepted iff ``EEst <= 1``."""
    return hairer_norm(scaled_error(err, y0, y1, rtol, atol))
