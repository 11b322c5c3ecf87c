"""K15: the whole-solve feature probe (counterpart of ``tools/spike_wholesolve.py``).

The TPU kernel probes the building blocks of the whole-solve kernels: a
while loop on the chip bounded by a step cap and by a carried time, a
dynamic scalar store each iteration, an asynchronous copy of the state into
a history row, and a small ``jax.vjp``. From ``(t0, y0)``, ``y0`` of shape
``(B, D)`` float32::

    tel[0:maxs] = 0; i = 0; t = t0; y = y0
    while i < maxs and t < 1:
        tel[i] = t; hy[i] = y
        y2 = tanh(y + 0.1 t)
        g = vjp(u -> tanh(0.5 u), y2)(0.01 y2)
        y = y2 + g; t += 0.25; i += 1
    y1 = y

``spike_wholesolve`` returns ``(y1, tel, hy, n)``: ``y1`` ``(B, D)``,
``tel`` ``(maxs, 1)``, ``hy`` ``(maxs, B, D)`` (JAX pads its last axis to
the TPU's 128 lanes; the port does not) and ``n`` the iterations run. Rows
``>= n`` of ``hy`` are unspecified, as in JAX. The vjp is written by hand in
the order of JAX's tanh rule: ``a = tanh(y2 * 0.5)``, ``c = y2 * 0.01``,
``g = ((c + c a) (1 - a)) * 0.5``.

The wrapper takes the plain version (``plain_spike_wholesolve``) for a CPU
tensor and launches the kernel (``csrc/spike_wholesolve.cu``) for a CUDA
tensor; the kernel's bulk copy needs ``B * D`` to be a multiple of 4.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"spike_wholesolve": 0}

B, D, MAXS = 32, 20, 16  # tools/spike_wholesolve.py


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def spike_update(y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """One iteration's update of the state at time ``t`` (a 0-d float32
    tensor), op by op as the kernel rounds it."""
    y2 = torch.tanh(y + 0.1 * t)
    a = torch.tanh(y2 * 0.5)
    c = y2 * 0.01
    return y2 + ((c + c * a) * (1.0 - a)) * 0.5


def plain_spike_wholesolve(t0: float, y0: torch.Tensor, maxs: int = MAXS):
    """Plain version of K15: ``(y1, tel, hy, n)``, the rows of ``hy`` from
    ``n`` on zero."""
    t = torch.tensor(t0, dtype=torch.float32, device=y0.device)
    tel = y0.new_zeros((maxs, 1))
    hy = y0.new_zeros((maxs,) + tuple(y0.shape))
    y, i = y0, 0
    while i < maxs and bool(t < 1.0):
        tel[i, 0] = t
        hy[i] = y
        y = spike_update(y, t)
        t = t + 0.25
        i += 1
    return y, tel, hy, i


def _cuda_spike_wholesolve(t0, y0, maxs):
    """Launches K15 without a host sync: ``n`` stays a ``(1,)`` int32 tensor
    on the card."""
    from regneuralde_tpu_torch.ops import _cuda

    if y0.dim() != 2 or y0.dtype != torch.float32 or not y0.is_contiguous():
        raise ValueError(f"y0 must be a contiguous float32 (B, D) tensor, got {y0.dtype} "
                         f"{tuple(y0.shape)}")
    if y0.numel() % 4 or y0.numel() == 0:
        raise ValueError(f"the kernel's bulk copy moves 16-byte rows: B * D must be a "
                         f"positive multiple of 4, got {y0.numel()}")
    if maxs < 1:
        raise ValueError(f"maxs must be positive, got {maxs}")
    lib = _cuda.library()
    dev = y0.device
    y1 = torch.empty_like(y0)
    tel = torch.empty((maxs, 1), device=dev)
    hy = torch.empty((maxs,) + tuple(y0.shape), device=dev)
    n = torch.empty(1, dtype=torch.int32, device=dev)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    code = lib.regnde_spike_wholesolve(
        float(t0), ptr(y0), ptr(y1), ptr(tel), ptr(hy), ptr(n), y0.numel(), maxs,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _cuda.check(code, "K15 (spike whole-solve) kernel")
    LAUNCHES["spike_wholesolve"] += 1
    return y1, tel, hy, n


def spike_wholesolve(t0: float, y0: torch.Tensor, maxs: int = MAXS):
    """K15 or its plain version: ``(y1, tel, hy, n)``."""
    if y0.device.type == "cuda":
        y1, tel, hy, n = _cuda_spike_wholesolve(t0, y0, maxs)
        return y1, tel, hy, int(n.item())
    if y0.device.type == "cpu":
        return plain_spike_wholesolve(t0, y0, maxs)
    raise RuntimeError(f"no K15 for device {y0.device}")
