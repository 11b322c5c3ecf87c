"""Per-sample adaptive stepping (counterpart of ``regneuralde_tpu/ops/per_sample.py``).

The default solve treats the whole minibatch as one ODE state with one
global error norm. Per-sample mode gives every batch element its own PI
controller: its own error norm, dt sequence, accept/reject decisions,
telemetry rows and NFE count. The port serves it through the
per-lane-controller batched engine (``ops.per_sample_batched``) for a 2-D
``(batch, dim)`` state. Not ported yet, raising ``NotImplementedError``
(``ROADMAP.md`` queue 1 item 3): the vmap engine (``engine="vmap"``, JAX's
default, a ``jax.vmap`` of the single-sample solve), pytree states (JAX
flattens them onto the batched engine) and ``sdeint_per_sample``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from regneuralde_tpu_torch.ops.ode import ODESolution

__all__ = ["odeint_per_sample"]

_NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item 3)"


def _check_batch(y0) -> int:
    if not isinstance(y0, torch.Tensor):
        raise NotImplementedError(
            f"per-sample solves of pytree states {_NOT_PORTED}; pass one (batch, dim) tensor")
    if y0.dim() == 0:
        raise ValueError(
            "per-sample mode needs every y0 leaf to carry the sample axis first; "
            f"got shapes {[tuple(y0.shape)]}")
    return y0.shape[0]


def _check_tspan(name, arr, batch):
    if arr.dim() not in (0, 1) or (arr.dim() == 1 and arr.shape[0] != batch):
        raise ValueError(
            f"{name} must be a scalar or a ({batch},) per-sample array; got shape "
            f"{tuple(arr.shape)}")


def _reject_global_kwargs(kwargs):
    for key in ("axis_name", "stage_sweep", "stage_sweep_bwd"):
        if kwargs.get(key) is not None:
            raise ValueError(
                f"per-sample solves do not accept {key!r}: per-sample step control is "
                "shard-local by construction and fused sweeps assume one shared controller")
        kwargs.pop(key, None)


def _split_saveat(kwargs, batch):
    """Pop ``saveat``: ``None``, a shared ``(n_save,)`` grid or a per-sample
    ``(batch, n_save)`` grid."""
    sa = kwargs.pop("saveat", None)
    if sa is None:
        return None
    sa = torch.as_tensor(sa)
    if sa.dim() == 1 or (sa.dim() == 2 and sa.shape[0] == batch):
        return sa
    raise ValueError("saveat must be a shared (n_save,) grid or a per-sample "
                     f"({batch}, n_save) grid; got shape {tuple(sa.shape)}")


def odeint_per_sample(func: Callable, y0, t0, t1, args: Any = (), engine: str = "vmap",
                      **kwargs) -> ODESolution:
    """Integrate every batch element under its own adaptive controller.

    ``func(t, y, args)`` is the batched dynamics ``odeint`` takes; ``t``
    reaches it as a ``(batch,)`` vector. ``y0`` is ``(batch, dim)``; ``t0``,
    ``t1`` scalars or ``(batch,)`` vectors (per-sample STEER). ``kwargs``
    go to ``odeint_per_sample_batched`` (solver, rtol, atol, max_steps,
    saveat, controller, mode, stage_sweep_lanes, stage_sweep_lanes_bwd);
    ``mode="while"`` runs the batched engine's forward alone.

    Returns an ``ODESolution`` whose ``stats`` fields are ``(batch,)``
    tensors and whose telemetry streams are ``(batch, max_steps)``; the
    ``reg`` reductions take them unchanged. Only ``engine="batched"`` is
    ported.
    """
    _reject_global_kwargs(kwargs)
    batch = _check_batch(y0)
    saveat = _split_saveat(kwargs, batch)
    if engine == "vmap":
        raise NotImplementedError(
            f"engine='vmap' {_NOT_PORTED}; use engine='batched'")
    if engine != "batched":
        raise ValueError(f"engine must be 'vmap' or 'batched', got {engine!r}")
    if y0.dim() != 2:
        raise NotImplementedError(
            f"per-sample solves of a state of shape {tuple(y0.shape)} (JAX flattens it to "
            f"(batch, D)) {_NOT_PORTED}")
    _check_tspan("t0", torch.as_tensor(t0), batch)
    _check_tspan("t1", torch.as_tensor(t1), batch)
    from regneuralde_tpu_torch.ops.per_sample_batched import odeint_per_sample_batched

    mode = kwargs.pop("mode", None) or "adjoint"
    return odeint_per_sample_batched(func, y0, t0, t1, args, mode=mode, saveat=saveat,
                                     **kwargs)
