"""Evaluation metrics (a port-side copy of ``loglikelihood`` in
``regneuralde_tpu/utils/metrics.py``, which cannot be imported without JAX)."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def loglikelihood(apply_fn: Callable, params, loader,
                  batches: Optional[int] = None, **kwargs) -> float:
    """Mean per-sample log-likelihood over a loader of ``x`` batches.

    ``apply_fn(params, x, **kwargs)`` gets each batch as a CPU tensor (it
    moves it to its device) and returns logpx, or an output whose first
    field is logpx (a tuple or a ``NamedTuple`` such as ``FFJORDOutput``).
    Reference: src/metrics.jl:20-33."""
    total_ll = 0.0
    total = 0
    for i, x in enumerate(loader):
        if batches is not None and i >= batches:
            break
        out = apply_fn(params, torch.as_tensor(x), **kwargs)
        logpx = out[0] if isinstance(out, tuple) else out
        total_ll += float(torch.sum(logpx))
        total += x.shape[0]
    return total_ll / max(total, 1)
