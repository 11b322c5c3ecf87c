"""Latent ODE: VAE-over-dynamics for irregular time series (counterpart of
``regneuralde_tpu/models/time_series.py``).

A recurrent encoder consumes the observation sequence backwards in time, an
MLP maps it to ``(mu0, logvar)`` of the initial latent, a reparameterized
sample is integrated by a Neural ODE to the ``saveat`` stamps, and a
per-stamp linear decoder maps back to observation space.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from regneuralde_tpu_torch.models.basic import init_linear
from regneuralde_tpu_torch.models.neural_ode import NeuralODE
from regneuralde_tpu_torch.ops.ode import StepTelemetry


class LatentTimeSeriesOutput(NamedTuple):
    result: torch.Tensor  # (batch, time, obs_dim)
    mu0: torch.Tensor
    logvar: torch.Tensor
    nfe: int
    telemetry: StepTelemetry
    success: bool  # the solver reached t1 within max_steps


class LatentTimeSeriesModel(nn.Module):
    """rnn -> enc -> reparameterize -> NeuralODE(saveat) -> dec.

    ``rnn`` maps ``(batch, time, feat)`` to ``(batch, 2 * latent_rnn)``,
    ``enc`` that to ``(batch, 2 * latent_ode)``, and ``dec`` latent states
    to observations. ``dec`` may be lazy (``nn.LazyLinear``, the
    counterpart of flax's ``Dense``): ``init`` sizes it by running the node
    once in ``"while"`` mode."""

    def __init__(self, rnn: nn.Module, enc: nn.Module, node: NeuralODE, dec: nn.Module):
        super().__init__()
        self.rnn = rnn
        self.enc = enc
        self.node = node
        self.dec = dec

    def _encode(self, x):
        out = self.enc(self.rnn(x))
        latent = out.shape[-1] // 2
        return out[:, :latent], out[:, latent:]

    @torch.no_grad()
    def init(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> "LatentTimeSeriesModel":
        """Materialize the decoder on the node's output at ``mu0`` and draw
        its weights from ``generator``."""
        z0, _ = self._encode(x)
        zs = self.node(z0, mode="while").value
        self.dec(zs.reshape((-1, zs.shape[-1])))
        if isinstance(self.dec, nn.Linear):
            init_linear(self.dec, generator)
        return self

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                saveat=None, tspan=None, mode: str = "adjoint",
                eps: Optional[torch.Tensor] = None) -> LatentTimeSeriesOutput:
        """``generator`` draws the reparameterization noise (the counterpart
        of JAX's ``key``); ``eps`` injects it instead (torch cannot draw
        JAX's threefry numbers, so a parity test feeds JAX's draw)."""
        mu0, logvar = self._encode(x)
        if eps is None:
            dev = generator.device if generator is not None else mu0.device
            eps = torch.randn(mu0.shape, generator=generator, dtype=mu0.dtype,
                              device=dev).to(mu0.device)
        z0 = eps * torch.exp(logvar / 2.0) + mu0
        out = self.node(z0, saveat=saveat, tspan=tspan, mode=mode)
        zs = out.value  # (batch, time, latent)
        b, t, d = zs.shape
        result = self.dec(zs.reshape((b * t, d))).reshape((b, t, -1))
        return LatentTimeSeriesOutput(
            result=result, mu0=mu0, logvar=logvar, nfe=out.nfe,
            telemetry=out.telemetry, success=out.solution.stats.success)
