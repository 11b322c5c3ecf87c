"""The ICML'21 solver-heuristic regularizers as masked reductions.

Counterpart of ``regneuralde_tpu/reg/__init__.py`` (its first part): the
solver emits ``StepTelemetry`` streams and each regularizer aggregates a
per-step value over the accepted steps, differentiably.
"""

from __future__ import annotations

import torch

from regneuralde_tpu_torch.ops.ode import StepTelemetry

__all__ = ["masked_mean", "masked_max", "masked_sum", "aggregate",
           "error_estimate", "stiffness_estimate"]


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    return torch.sum(values * m) / torch.clamp(torch.sum(m), min=1.0)


def masked_max(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    masked = torch.where(mask, values, torch.full_like(values, -torch.inf))
    out = torch.max(masked)
    # no accepted steps -> 0 (only on failed or empty solves)
    return torch.where(torch.any(mask), out, torch.zeros_like(out))


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(values * mask.to(values.dtype))


_AGGREGATIONS = {"mean": masked_mean, "max": masked_max, "sum": masked_sum}


def aggregate(values: torch.Tensor, mask: torch.Tensor, agg: str) -> torch.Tensor:
    try:
        return _AGGREGATIONS[agg](values, mask)
    except KeyError:
        raise ValueError(f"unknown aggregation {agg!r}; use mean/max/sum") from None


def _sanitize(x: torch.Tensor) -> torch.Tensor:
    """Zero out NaN entries, as the reference's save_funcs do."""
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def error_estimate(tel: StepTelemetry, agg: str = "mean") -> torch.Tensor:
    """ERNODE regularizer: ``agg`` over accepted steps of ``EEst * dt``."""
    vals = _sanitize(tel.eest * tel.dt.to(tel.eest.dtype))
    return aggregate(vals, tel.accepted, agg)


def stiffness_estimate(tel: StepTelemetry, stability_size: float,
                       agg: str = "max") -> torch.Tensor:
    """SRNODE regularizer: ``agg`` of ``|eigen_est| / stability_size``."""
    vals = _sanitize(torch.abs(tel.eigen_est)) / stability_size
    return aggregate(vals, tel.accepted, agg)
