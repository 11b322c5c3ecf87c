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
