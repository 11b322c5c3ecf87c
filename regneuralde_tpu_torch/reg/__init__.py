"""The ICML'21 solver-heuristic regularizers as masked reductions.

Counterpart of ``regneuralde_tpu/reg/__init__.py`` (its first part): the
solver emits ``StepTelemetry`` streams and each regularizer aggregates a
per-step value over the accepted steps, differentiably; per-sample streams
``(batch, max_steps)`` reduce over both axes. The STEER draws come from an
explicit ``torch.Generator`` (JAX's threefry keys give other numbers).
"""

from __future__ import annotations

import math

import torch

from regneuralde_tpu_torch.ops.ode import StepTelemetry

__all__ = ["masked_mean", "masked_max", "masked_sum", "aggregate",
           "error_estimate", "stiffness_estimate", "exp_decay_schedule", "steer_tspan",
           "steer_tspan_per_sample", "steer_saveat", "steer_saveat_per_sample"]


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


def exp_decay_schedule(lambda0: float, lambda1: float, epochs: int):
    """``lambda(t) = lambda0 * exp(-k t)`` with ``k = log(lambda0 / lambda1) /
    epochs``, in float32 as the JAX package computes it (a 0-d tensor)."""
    k = math.log(lambda0 / lambda1) / epochs

    def schedule(epoch) -> torch.Tensor:
        return lambda0 * torch.exp(-k * torch.as_tensor(epoch, dtype=torch.float32))

    return schedule


def _uniform(generator, shape, lo, hi):
    """``U(lo, hi)`` in float32 on ``generator``'s device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return lo + (hi - lo) * u


def steer_tspan(generator: torch.Generator, t0: float = 0.0, t1: float = 1.0,
                b: float = 0.5):
    """STEER: the end time ``t1 + u``, ``u ~ U(-b, b)``: ``(t0, t1)`` as
    float32 0-d tensors."""
    u = _uniform(generator, (), -b, b)
    return torch.tensor(t0, dtype=torch.float32, device=u.device), t1 + u


def steer_tspan_per_sample(generator: torch.Generator, batch: int, t0: float = 0.0,
                           t1: float = 1.0, b: float = 0.5):
    """STEER with an independent end time per sample, ``t1_i ~ U(t1 - b, t1
    + b)``, for per-sample solves: ``(t0, t1 of shape (batch,))``."""
    u = _uniform(generator, (batch,), -b, b)
    return torch.tensor(t0, dtype=torch.float32, device=u.device), t1 + u


def _jitter(saveat, u, lo, hi):
    """Each point after the first moves by ``u`` times half the gap to its
    predecessor, then the grid is clamped to ``[lo, hi]``."""
    gap = saveat[..., 1:] - saveat[..., :-1] + torch.finfo(saveat.dtype).eps
    out = torch.cat([saveat[..., :1].expand(u.shape[:-1] + (1,)),
                     saveat[..., 1:] + u * gap / 2.0], dim=-1)
    return torch.clamp(out, lo, hi)


def steer_saveat(generator: torch.Generator, saveat: torch.Tensor, lo: float = 0.0,
                 hi: float = 1.0) -> torch.Tensor:
    """STEER for saveat grids: interior points jittered by up to half the
    gap to their predecessor, the first kept, all clamped to ``[lo, hi]``."""
    u = _uniform(generator, (saveat.shape[0] - 1,), -1.0, 1.0).to(saveat.device)
    return _jitter(saveat, u, lo, hi)


def steer_saveat_per_sample(generator: torch.Generator, saveat: torch.Tensor, batch: int,
                            lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """``steer_saveat`` with an independent jitter per sample: a ``(batch,
    n_save)`` grid for per-sample solves (each row stays sorted)."""
    u = _uniform(generator, (batch, saveat.shape[0] - 1), -1.0, 1.0).to(saveat.device)
    return _jitter(saveat, u, lo, hi)
