"""Normed Tsit5 trial step of ``MLPDynamics``: plain PyTorch and CUDA kernels.

Counterpart of the normed part of ``regneuralde_tpu/ops/pallas_mlp.py``.
One trial step runs the six Tsit5 stages of ``MLPDynamics`` and reduces the
error and stiffness norms to three sums of squares, so only
``(y_new, k7, err_ssq, num_ssq, den_ssq)`` leave the step:

* ``err_ssq = sum((err / (atol + max(|y|, |y_new|) * rtol))^2)`` with the
  embedded error ``err = dt * sum_i btilde_i (k_i - k1)``;
* ``num_ssq = sum((k7 - k6)^2)`` and ``den_ssq = sum((y_new - g6)^2)``,
  the stiffness estimate's two norms.

The weights are the four leaves ``(W1, b1, W2, b2)`` of the two
``nn.Linear`` layers of ``models.basic.MLPDynamics``: ``W1`` is
``(H, D+1)`` and ``W2`` is ``(D, H+1)``, the time column last.

Each of the two steps has a plain version (``_reference_normed_sweep``,
and ``_normed_bwd_math``, the hand reverse chain of
``pallas_mlp._normed_bwd_math``) and a CUDA kernel
(``csrc/normed_tsit5.cu``). The wrappers ``normed_sweep_fwd`` and
``normed_sweep_bwd`` take the plain version for tensors on the CPU, launch
the kernel for tensors on a CUDA device, and raise otherwise.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from regneuralde_tpu_torch.ops.math import tanh as _tanh
from regneuralde_tpu_torch.ops.tableaus import TSIT5

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"normed_tsit5_fwd": 0, "normed_tsit5_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _split_params(W1, b1, W2, b2):
    """``(w1x, w1t, b1, w2h, w2t, b2)`` as views of the ``nn.Linear``
    leaves: ``w1x`` (H, D), ``w1t`` (H,), ``w2h`` (D, H), ``w2t`` (D,)."""
    return W1[:, :-1], W1[:, -1], b1, W2[:, :-1], W2[:, -1], b2


def _stage_acc(i, ks):
    acc = TSIT5.a[i - 1][0] * ks[0]
    for c, k in zip(TSIT5.a[i - 1][1:], ks[1:]):
        if c != 0.0:
            acc = acc + c * k
    return acc


def _mlp_k(yi, ti, parts):
    w1x, w1t, b1, w2h, w2t, b2 = parts
    h = _tanh(yi @ w1x.T + ti * w1t + b1)
    return _tanh(h @ w2h.T + ti * w2t + b2), h


def _reference_sweep(t, dt, y, k1, parts):
    """Plain Tsit5 trial step: ``(y_new, k7, err, k6, g6)``."""
    ks = [k1]
    y_stage = y
    g6 = y
    for i in range(1, 7):
        y_stage = y + dt * _stage_acc(i, ks)
        ks.append(_mlp_k(y_stage, t + TSIT5.c[i] * dt, parts)[0])
        if i == 5:
            g6 = y_stage
    err = TSIT5.btilde[1] * (ks[1] - ks[0])
    for c, k in zip(TSIT5.btilde[2:], ks[2:]):
        err = err + c * (k - ks[0])
    return y_stage, ks[-1], dt * err, ks[-2], g6


def _reference_normed_sweep(t, dt, y, k1, parts, rtol, atol):
    """Plain version of K1: ``(y_new, k7, err_ssq, num_ssq, den_ssq)``."""
    y_new, k7, err, k6, g6 = _reference_sweep(t, dt, y, k1, parts)
    denom = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
    scaled = err / denom
    dk = k7 - k6
    dg = y_new - g6
    return (y_new, k7, torch.sum(scaled * scaled), torch.sum(dk * dk),
            torch.sum(dg * dg))


def _normed_bwd_math(t, dt, y, k1, parts, cts, rtol, atol):
    """Plain version of K2: the hand reverse chain of the normed step.

    Maps ``cts = (ct_y_new, ct_k7, ct_err_ssq, ct_num_ssq, ct_den_ssq)``
    to ``(ct_t, ct_dt, ct_y, ct_k1, (cW1, cb1, cW2, cb2))``. All of the
    ``max(|y|, |y_new|)`` subgradient goes to ``y`` on ties, as in
    ``pallas_mlp._normed_bwd_math``; ``torch.autograd`` of the plain
    forward would split it."""
    tab = TSIT5
    w1x, w1t, b1, w2h, w2t, b2 = parts
    cyn, ck7, ct_errssq, ct_numssq, ct_denssq = cts

    ks = [k1]
    hs = []
    for i in range(1, 7):
        yi = y + dt * _stage_acc(i, ks)
        k, h = _mlp_k(yi, t + tab.c[i] * dt, parts)
        ks.append(k)
        hs.append(h)
    y_new = y + dt * _stage_acc(6, ks)

    s_comb = tab.btilde[1] * (ks[1] - ks[0])
    for c, k in zip(tab.btilde[2:], ks[2:]):
        s_comb = s_comb + c * (k - ks[0])
    err = dt * s_comb
    denom = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
    scaled = err / denom
    cerr = ct_errssq * 2.0 * scaled / denom
    cdenom = ct_errssq * (-2.0) * scaled * scaled / denom
    y_is_max = torch.abs(y) >= torch.abs(y_new)
    zero = torch.zeros_like(y)
    to_y = torch.where(y_is_max, cdenom * rtol * torch.sign(y), zero)
    to_ynew = torch.where(y_is_max, zero, cdenom * rtol * torch.sign(y_new))

    d_k7 = ct_numssq * 2.0 * (ks[6] - ks[5])
    d_ynew = ct_denssq * 2.0 * (y_new - (y + dt * _stage_acc(5, ks)))

    ct_ks = [tab.btilde[j] * (dt * cerr) for j in range(7)]
    ct_ks[6] = ct_ks[6] + ck7 + d_k7
    ct_ks[5] = ct_ks[5] - d_k7
    seeds = {6: cyn + d_ynew + to_ynew, 5: -d_ynew}

    ct_dt = torch.sum(cerr * s_comb)
    ct_t = torch.zeros_like(ct_dt)
    ct_y = to_y
    cw1x = torch.zeros_like(w1x)
    cw1t = torch.zeros_like(w1t)
    cb1 = torch.zeros_like(b1)
    cw2h = torch.zeros_like(w2h)
    cw2t = torch.zeros_like(w2t)
    cb2 = torch.zeros_like(b2)
    for i in range(6, 0, -1):
        k_i, h_i = ks[i], hs[i - 1]
        acc = _stage_acc(i, ks)
        yi = y + dt * acc
        ti = t + tab.c[i] * dt

        ct_pre2 = ct_ks[i] * (1.0 - k_i * k_i)
        cw2h = cw2h + ct_pre2.T @ h_i
        rows2 = torch.sum(ct_pre2, dim=0)
        cw2t = cw2t + ti * rows2
        cb2 = cb2 + rows2
        ct_ti = torch.sum(ct_pre2 * w2t)

        ct_pre1 = (ct_pre2 @ w2h) * (1.0 - h_i * h_i)
        cw1x = cw1x + ct_pre1.T @ yi
        rows1 = torch.sum(ct_pre1, dim=0)
        cw1t = cw1t + ti * rows1
        cb1 = cb1 + rows1
        ct_ti = ct_ti + torch.sum(ct_pre1 * w1t)

        ct_yi = ct_pre1 @ w1x
        if i in seeds:
            ct_yi = seeds[i] + ct_yi
        ct_y = ct_y + ct_yi
        ct_dt = ct_dt + torch.sum(ct_yi * acc) + tab.c[i] * ct_ti
        ct_t = ct_t + ct_ti
        for j, c in enumerate(tab.a[i - 1]):
            if c != 0.0:
                ct_ks[j] = ct_ks[j] + (dt * c) * ct_yi

    ct_leaves = (torch.cat([cw1x, cw1t[:, None]], dim=1), cb1,
                 torch.cat([cw2h, cw2t[:, None]], dim=1), cb2)
    return ct_t, ct_dt, ct_y, ct_ks[0], ct_leaves


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, kernel for CUDA tensors.
# ---------------------------------------------------------------------------


def _check_cuda_args(y, k1, leaves, extra=()):
    B, D = y.shape if y.dim() == 2 else (None, None)
    if B is None:
        raise ValueError(f"y must be (batch, dim), got {tuple(y.shape)}")
    W1, b1, W2, b2 = leaves
    H = W1.shape[0]
    want = {"k1": (k1, (B, D)), "W1": (W1, (H, D + 1)), "b1": (b1, (H,)),
            "W2": (W2, (D, H + 1)), "b2": (b2, (D,))}
    want.update(extra)
    for name, (x, shape) in {"y": (y, (B, D)), **want}.items():
        if x.device != y.device:
            raise ValueError(f"{name} is on {x.device}, y on {y.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, D, H


def _scalar_f32(x, like):
    x = torch.as_tensor(x, device=like.device)
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x.reshape(()).contiguous()


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _cuda_normed_fwd(t, dt, y, k1, leaves, rtol, atol):
    from regneuralde_tpu_torch.ops import _cuda

    B, D, H = _check_cuda_args(y, k1, leaves)
    lib = _cuda.library()
    t32, dt32 = _scalar_f32(t, y), _scalar_f32(dt, y)
    y_new = torch.empty_like(y)
    k7 = torch.empty_like(y)
    rows = lib.regnde_fwd_rows()
    partials = torch.empty(((B + rows - 1) // rows, 3), device=y.device)
    sums = torch.empty(3, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    code = lib.regnde_normed_fwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), *map(_ptr, leaves),
        _ptr(y_new), _ptr(k7), _ptr(partials), _ptr(sums), B, D, H,
        float(rtol), float(atol), ctypes.c_void_p(stream))
    _cuda.check(code, "normed Tsit5 forward kernel")
    LAUNCHES["normed_tsit5_fwd"] += 1
    return y_new, k7, sums[0], sums[1], sums[2]


def _cuda_normed_bwd(t, dt, y, k1, leaves, cts, rtol, atol):
    from regneuralde_tpu_torch.ops import _cuda

    cyn, ck7 = cts[0], cts[1]
    B, D, H = _check_cuda_args(
        y, k1, leaves, {"ct_y_new": (cyn, tuple(y.shape)),
                        "ct_k7": (ck7, tuple(y.shape))})
    lib = _cuda.library()
    t32, dt32 = _scalar_f32(t, y), _scalar_f32(dt, y)
    ct_scalars = torch.stack([_scalar_f32(c, y) for c in cts[2:]]).contiguous()
    dev = y.device
    ct_y = torch.empty_like(y)
    ct_k1 = torch.empty_like(y)
    W1, b1, W2, b2 = leaves
    cW1, cb1 = torch.empty_like(W1), torch.empty_like(b1)
    cW2, cb2 = torch.empty_like(W2), torch.empty_like(b2)
    ct_tdt = torch.empty(2, device=dev)
    rows = lib.regnde_bwd_rows()
    partials = torch.empty(((B + rows - 1) // rows, 2), device=dev)
    cp2 = torch.empty((6 * B, D), device=dev)
    he = torch.empty((6 * B, H + 2), device=dev)
    cp1 = torch.empty((6 * B, H), device=dev)
    ye = torch.empty((6 * B, D + 2), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.regnde_normed_bwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), *map(_ptr, leaves),
        _ptr(cyn), _ptr(ck7), _ptr(ct_scalars), _ptr(ct_y), _ptr(ct_k1),
        _ptr(cW1), _ptr(cb1), _ptr(cW2), _ptr(cb2), _ptr(ct_tdt),
        _ptr(partials), _ptr(cp2), _ptr(he), _ptr(cp1), _ptr(ye), B, D, H,
        float(rtol), float(atol), ctypes.c_void_p(stream))
    _cuda.check(code, "normed Tsit5 backward kernel")
    LAUNCHES["normed_tsit5_bwd"] += 1
    return ct_tdt[0], ct_tdt[1], ct_y, ct_k1, (cW1, cb1, cW2, cb2)


def normed_sweep_fwd(t, dt, y, k1, leaves: Sequence[torch.Tensor], rtol, atol):
    """K1 or its plain version: ``(y_new, k7, err_ssq, num_ssq, den_ssq)``."""
    if y.device.type == "cuda":
        return _cuda_normed_fwd(t, dt, y, k1, tuple(leaves), rtol, atol)
    if y.device.type == "cpu":
        return _reference_normed_sweep(t, dt, y, k1, _split_params(*leaves),
                                       rtol, atol)
    raise RuntimeError(f"no normed Tsit5 forward for device {y.device}")


def normed_sweep_bwd(t, dt, y, k1, leaves: Sequence[torch.Tensor], cts, rtol,
                     atol):
    """K2 or its plain version: ``(ct_t, ct_dt, ct_y, ct_k1, ct_leaves)``."""
    if y.device.type == "cuda":
        return _cuda_normed_bwd(t, dt, y, k1, tuple(leaves), tuple(cts), rtol,
                                atol)
    if y.device.type == "cpu":
        return _normed_bwd_math(t, dt, y, k1, _split_params(*leaves),
                                tuple(cts), rtol, atol)
    raise RuntimeError(f"no normed Tsit5 backward for device {y.device}")


class NormedSweepFn(torch.autograd.Function):
    """The normed trial step with the hand backward as its gradient."""

    @staticmethod
    def forward(ctx, t, dt, y, k1, W1, b1, W2, b2, rtol, atol):
        ctx.save_for_backward(t, dt, y, k1, W1, b1, W2, b2)
        ctx.tols = (rtol, atol)
        return normed_sweep_fwd(t, dt, y, k1, (W1, b1, W2, b2), rtol, atol)

    @staticmethod
    def backward(ctx, cyn, ck7, ce, cn, cd):
        t, dt, y, k1, *leaves = ctx.saved_tensors
        scalar0 = y.new_zeros(())
        cts = (torch.zeros_like(y) if cyn is None else cyn.contiguous(),
               torch.zeros_like(y) if ck7 is None else ck7.contiguous(),
               *(scalar0 if c is None else c for c in (ce, cn, cd)))
        ct_t, ct_dt, ct_y, ct_k1, ct_leaves = normed_sweep_bwd(
            t, dt, y, k1, leaves, cts, *ctx.tols)
        return (ct_t.to(t.dtype).reshape(t.shape),
                ct_dt.to(dt.dtype).reshape(dt.shape), ct_y, ct_k1,
                *ct_leaves, None, None)


def mlp_dynamics_normed_sweep(t, dt, y, k1, leaves, rtol, atol):
    """Normed ``stage_sweep`` for ``ops.ode.odeint`` over MLPDynamics
    leaves ``(W1, b1, W2, b2)``; differentiable through ``NormedSweepFn``."""
    from regneuralde_tpu_torch.ops.ode import NormedSweep

    t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
    dt = torch.as_tensor(dt, dtype=y.dtype, device=y.device)
    return NormedSweep(*NormedSweepFn.apply(t, dt, y, k1, *leaves,
                                            float(rtol), float(atol)))


def mlp_dynamics_normed_sweep_bwd(t, dt, y, k1, leaves, cts, rtol, atol
                                  ) -> Tuple:
    """Direct backward of the normed step for the fast adjoint solve: one
    K2 launch (or its plain version), no forward replay."""
    return normed_sweep_bwd(t, dt, y, k1, tuple(leaves), tuple(cts),
                            float(rtol), float(atol))


def plain_mlp_normed_sweep(t, dt, y, k1, leaves, rtol, atol):
    """The plain version of K1 on any device, as a ``stage_sweep``: the
    unfused path of ``NeuralODE(fused=False)``, the same trial-step algebra
    with no kernel (its reverse is ``plain_mlp_normed_sweep_bwd``)."""
    from regneuralde_tpu_torch.ops.ode import NormedSweep

    return NormedSweep(*_reference_normed_sweep(
        t, dt, y, k1, _split_params(*leaves), float(rtol), float(atol)))


def plain_mlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, rtol, atol):
    """The plain version of K2 on any device (``NeuralODE(fused=False)``)."""
    return _normed_bwd_math(t, dt, y, k1, _split_params(*leaves), tuple(cts),
                            float(rtol), float(atol))
