"""Whole adaptive Tsit5 solve of ``MLPDynamics``: one kernel per direction.

Counterpart of ``regneuralde_tpu/ops/pallas_solve.py``: ``whole_solve_odeint``
(the monolithic engine, K3/K4) and ``whole_solve_odeint_tiled`` (the tiled
engine, K5/K6) become one pair of persistent CUDA kernels
(``csrc/whole_solve.cu``). The forward runs every trial step of the
adaptive loop on the device; the backward walks its history in reverse.
Neither returns to the host between trial steps.

The forward's record (``SolveRecord``) is what the backward reads: per
trial step its start state ``t, dt, qold``, the three norm sums, the
accept flag and the rows ``y, f0``. The backward takes the stored accept
flags and norm sums (the tiled engine's choice, ``pallas_solve.py``
``make_whole_solve_tiled``) and re-runs the scalar chain only to pull
cotangents back through it, with the hand pullback ``ode.post_bwd``.

Each kernel has a plain version with the same algebra and the same output
buffers: ``plain_whole_solve_fwd`` (the trial-step loop of
``ode._solve_forward`` over K1's plain version) and
``plain_whole_solve_bwd`` (the reverse walk of ``ode.FastAdjointSolve``
with ``post_bwd`` in place of autograd, over K2's plain version). The
wrappers ``whole_solve_fwd`` and ``whole_solve_bwd`` take the plain version
for tensors on the CPU, launch the kernel for tensors on a CUDA device,
and raise otherwise.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops.controller import PIController
from regneuralde_tpu_torch.ops.ode import (
    AdjointCarry,
    NormedSweep,
    ODESolution,
    StepTelemetry,
    _post,
    _solve_forward,
    adjoint_step,
    post_bwd,
    solve_prologue,
    solve_stats,
)
from regneuralde_tpu_torch.ops.tableaus import TSIT5

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"whole_solve_fwd": 0, "whole_solve_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Rows of ``SolveRecord.streams``.
(ST_T, ST_DT, ST_QOLD, ST_E, ST_N, ST_D, ST_ACC,
 TEL_T, TEL_DT, TEL_EEST, TEL_EIGEN) = range(11)
N_STREAMS = 11


class SolveRecord(NamedTuple):
    """What the forward solve writes (``S = max_steps``, ``ns`` trial steps).

    ``hy[i]``/``hf[i]`` hold the state and FSAL derivative at the start of
    trial step ``i`` for ``i <= ns`` (``hy[ns]`` is ``y1``; ``hf[ns]`` is
    not part of the result); later rows are undefined. ``streams`` is
    ``(11, S)``: per trial step its start ``t, dt, qold``, the norm sums
    ``err_ssq, num_ssq, den_ssq``, the accept flag (1.0 or 0.0), and the
    telemetry ``t_end, dt_eff, eest, eigen_est``; zero past step ``ns``.
    ``final`` is ``(t, dt, qold, naccept, nreject, done)``."""

    y1: torch.Tensor
    hy: torch.Tensor
    hf: torch.Tensor
    streams: torch.Tensor
    final: torch.Tensor


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def plain_whole_solve_fwd(t0, t1, dt0, y0, f0, leaves, rtol, atol,
                          ctrl: PIController, max_steps: int) -> SolveRecord:
    """Plain version of K3: the trial-step loop over K1's plain version."""
    parts = fm._split_params(*leaves)

    def sweep(t, dt, y, k1, _):
        return NormedSweep(*fm._reference_normed_sweep(t, dt, y, k1, parts,
                                                       rtol, atol))

    y1, rows, accepted, done, hist = _solve_forward(
        sweep, ctrl, max_steps, t0, t1, dt0, y0, f0, (), keep_history=True)
    ns = len(hist)
    hy = y0.new_zeros((max_steps + 1,) + tuple(y0.shape))
    hf = torch.zeros_like(hy)
    streams = t0.new_zeros((N_STREAMS, max_steps))
    for i, (t, dt, qold, e, n, d, y, f) in enumerate(hist):
        hy[i], hf[i] = y, f
        streams[:ST_ACC, i] = torch.stack((t, dt, qold, e, n, d))
        streams[ST_ACC, i] = float(accepted[i])
        streams[TEL_T:, i] = torch.stack(rows[i])
    hy[ns] = y1
    if ns:
        # the loop's final (t, dt, qold): the last step's scalar chain again
        t, dt, qold, e, n, d = hist[-1][:6]
        tdir = torch.sign(t1 - t0)
        remaining = t1 - t
        is_last = (dt - remaining) * tdir >= 0
        t, dt, qold = _post(ctrl, float(y0.numel()), t, torch.where(is_last, remaining, dt),
                            qold, e, n, d, t1, torch.abs(t1 - t0), is_last)[:3]
    else:
        t, dt, qold = t0, dt0, torch.full_like(t0, ctrl.qoldinit)
    na = sum(accepted)
    final = torch.stack((t, dt, qold)).to(streams.dtype)
    final = torch.cat([final, final.new_tensor([na, ns - na, float(done)])])
    return SolveRecord(y1, hy, hf, streams, final)


def plain_whole_solve_bwd(rec: SolveRecord, ns: int, ct_y1, ct_tel, t0, t1,
                          leaves, rtol, atol, ctrl: PIController):
    """Plain version of K4: the reverse walk over ``rec``'s ``ns`` trial
    steps, ``post_bwd`` for the scalar chain and K2's plain version for
    the trial step. ``ct_tel`` is ``(4, S)``, the cotangents of the
    telemetry streams ``t, dt, eest, eigen_est``. Returns ``(ct_t0, ct_t1,
    ct_dt0, ct_y0, ct_f0, *ct_leaves)``."""
    parts = fm._split_params(*leaves)

    def sweep_bwd(t, dt, y, k1, _, cts):
        return fm._normed_bwd_math(t, dt, y, k1, parts, cts, rtol, atol)

    tdir = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)
    count = float(rec.y1.numel())
    zero = torch.zeros_like(t0)
    carry = AdjointCarry(zero, zero, zero, ct_y1, torch.zeros_like(ct_y1),
                         [torch.zeros_like(x) for x in leaves], zero, zero)
    st = rec.streams
    accepted = (st[ST_ACC, :ns] > 0.5).tolist()
    for i in range(ns - 1, -1, -1):
        t_i, dt_i, qold_i, e_i, n_i, d_i = st[:ST_ACC, i]
        remaining = t1 - t_i
        is_last = (dt_i - remaining) * tdir >= 0
        dt_eff = torch.where(is_last, remaining, dt_i)
        acc = torch.tensor(accepted[i], device=st.device)
        dp = post_bwd(ctrl, count, t_i, dt_eff, qold_i, e_i, n_i, d_i, t1, span,
                      is_last, acc, (carry.ct_t, carry.ct_dt, carry.ct_qold,
                                     ct_tel[0, i], ct_tel[2, i], ct_tel[3, i]))
        carry = adjoint_step(sweep_bwd, leaves, (t_i, dt_eff, rec.hy[i], rec.hf[i]),
                             accepted[i], is_last, dp, ct_tel[1, i], carry)
    return carry.finish(tdir)


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, kernel for CUDA tensors.
# ---------------------------------------------------------------------------


def _ctrl_args(ctrl: PIController):
    return [float(x) for x in (ctrl.beta1, ctrl.beta2, ctrl.qmin, ctrl.qmax,
                               ctrl.gamma, ctrl.qoldinit, ctrl.qsteady_max)]


def _cuda_whole_solve_fwd(t0, t1, dt0, y0, f0, leaves, rtol, atol, ctrl,
                          max_steps):
    from regneuralde_tpu_torch.ops import _cuda

    B, D, H = fm._check_cuda_args(y0, f0, leaves)
    if max_steps < 1:
        raise ValueError(f"max_steps must be positive, got {max_steps}")
    lib = _cuda.library()
    ptr = fm._ptr
    scalars = torch.stack([fm._scalar_f32(x, y0) for x in (t0, t1, dt0)])
    dev = y0.device
    y1 = torch.empty_like(y0)
    hy = torch.empty((max_steps + 1, B, D), device=dev)
    hf = torch.empty_like(hy)
    streams = torch.zeros((N_STREAMS, max_steps), device=dev)
    final = torch.empty(6, device=dev)
    rows = lib.regnde_fwd_rows()
    partials = torch.empty((2, (B + rows - 1) // rows, 3), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.regnde_whole_solve_fwd(
        ptr(scalars), ptr(y0), ptr(f0), *map(ptr, leaves), ptr(y1), ptr(hy),
        ptr(hf), ptr(streams), ptr(final), ptr(partials), B, D, H, max_steps,
        float(rtol), float(atol), *_ctrl_args(ctrl), ctypes.c_void_p(stream))
    _cuda.check(code, "whole-solve forward kernel")
    LAUNCHES["whole_solve_fwd"] += 1
    return SolveRecord(y1, hy, hf, streams, final)


def _cuda_whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, rtol, atol,
                          ctrl):
    from regneuralde_tpu_torch.ops import _cuda

    y1 = rec.y1
    B, D, H = fm._check_cuda_args(y1, ct_y1, leaves)
    S = rec.streams.shape[1]
    for name, x, shape in (("ct_tel", ct_tel, (4, S)), ("hy", rec.hy, (S + 1, B, D)),
                           ("hf", rec.hf, (S + 1, B, D)),
                           ("streams", rec.streams, (N_STREAMS, S))):
        if (x.device != y1.device or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {y1.device}")
    if not 0 <= ns <= S:
        raise ValueError(f"ns must lie in [0, {S}], got {ns}")
    lib = _cuda.library()
    ptr = fm._ptr
    dev = y1.device
    scalars = torch.stack([fm._scalar_f32(x, y1) for x in (t0, t1)])
    ct_y = ct_y1.clone()
    ct_f = torch.zeros_like(ct_y)
    W1, b1, W2, b2 = leaves
    cW1, cb1 = torch.empty_like(W1), torch.empty_like(b1)
    cW2, cb2 = torch.empty_like(W2), torch.empty_like(b2)
    ct_scalars = torch.empty(3, device=dev)
    rows = lib.regnde_bwd_rows()
    partials = torch.empty((2, (B + rows - 1) // rows, 2), device=dev)
    # the weight-cotangent rows of every trial step, summed after the walk
    K = 6 * B * ns
    cp2 = torch.empty((K, D), device=dev)
    he = torch.empty((K, H + 2), device=dev)
    cp1 = torch.empty((K, H), device=dev)
    ye = torch.empty((K, D + 2), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.regnde_whole_solve_bwd(
        ptr(scalars), ptr(rec.streams), ptr(rec.hy), ptr(rec.hf),
        *map(ptr, leaves), ptr(ct_tel), ptr(ct_y), ptr(ct_f), ptr(cW1),
        ptr(cb1), ptr(cW2), ptr(cb2), ptr(ct_scalars), ptr(partials), ptr(cp2),
        ptr(he), ptr(cp1), ptr(ye), ns, B, D, H, S, float(rtol), float(atol),
        *_ctrl_args(ctrl), ctypes.c_void_p(stream))
    _cuda.check(code, "whole-solve backward kernel")
    LAUNCHES["whole_solve_bwd"] += 1
    return (ct_scalars[0], ct_scalars[1], ct_scalars[2], ct_y, ct_f,
            cW1, cb1, cW2, cb2)


def whole_solve_fwd(t0, t1, dt0, y0, f0, leaves: Sequence[torch.Tensor], rtol,
                    atol, ctrl: PIController, max_steps: int) -> SolveRecord:
    """K3 or its plain version: the whole forward solve."""
    if y0.device.type == "cuda":
        return _cuda_whole_solve_fwd(t0, t1, dt0, y0, f0, tuple(leaves), rtol,
                                     atol, ctrl, max_steps)
    if y0.device.type == "cpu":
        return plain_whole_solve_fwd(t0, t1, dt0, y0, f0, tuple(leaves), rtol,
                                     atol, ctrl, max_steps)
    raise RuntimeError(f"no whole-solve forward for device {y0.device}")


def whole_solve_bwd(rec: SolveRecord, ns: int, ct_y1, ct_tel, t0, t1,
                    leaves: Sequence[torch.Tensor], rtol, atol,
                    ctrl: PIController):
    """K4 or its plain version: ``(ct_t0, ct_t1, ct_dt0, ct_y0, ct_f0,
    *ct_leaves)``."""
    if ct_y1.device.type == "cuda":
        return _cuda_whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1,
                                     tuple(leaves), rtol, atol, ctrl)
    if ct_y1.device.type == "cpu":
        return plain_whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1,
                                     tuple(leaves), rtol, atol, ctrl)
    raise RuntimeError(f"no whole-solve backward for device {ct_y1.device}")


# ---------------------------------------------------------------------------
# The differentiable solve and its odeint-compatible front end.
# ---------------------------------------------------------------------------


class WholeSolveFn(torch.autograd.Function):
    """The whole solve with K4 as its gradient. Inputs ``t0, t1, dt_init,
    y0, f0_init`` and the leaves ``(W1, b1, W2, b2)``; outputs those of
    ``ode.FastAdjointSolve``: ``y1``, the telemetry streams ``t, dt, eest,
    eigen_est``, and, not differentiable, the accept and live masks and
    ``(naccept, nreject, done)``."""

    @staticmethod
    def forward(ctx, ctrl, max_steps, rtol, atol, t0, t1, dt_init, y0, f0_init,
                *leaves):
        rec = whole_solve_fwd(t0, t1, dt_init, y0, f0_init, leaves, rtol, atol,
                              ctrl, max_steps)
        # the one host sync of the solve: the step counts size the backward
        na, nr, done = (int(v) for v in rec.final[3:].tolist())
        st = rec.streams
        accepted = st[ST_ACC] > 0.5
        live = torch.arange(max_steps, device=st.device) < na + nr
        counts = torch.tensor([na, nr, done])
        ctx.mark_non_differentiable(accepted, live, counts)
        ctx.rec, ctx.ns = rec, na + nr
        ctx.args = (ctrl, rtol, atol)
        ctx.save_for_backward(t0, t1, *leaves)
        return (rec.y1, st[TEL_T].clone(), st[TEL_DT].clone(),
                st[TEL_EEST].clone(), st[TEL_EIGEN].clone(), accepted, live,
                counts)

    @staticmethod
    def backward(ctx, ct_y1, ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g, *_):
        t0, t1, *leaves = ctx.saved_tensors
        ctrl, rtol, atol = ctx.args
        rec = ctx.rec
        S = rec.streams.shape[1]
        ct_tel = torch.stack([
            rec.streams.new_zeros(S) if c is None else c.to(rec.streams.dtype)
            for c in (ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g)])
        ct_y1 = torch.zeros_like(rec.y1) if ct_y1 is None else ct_y1.contiguous()
        grads = whole_solve_bwd(rec, ctx.ns, ct_y1, ct_tel, t0, t1, leaves, rtol,
                                atol, ctrl)
        ctx.rec = None
        ct_t0, ct_t1, ct_dt0 = (g.to(t0.dtype).reshape(t0.shape) for g in grads[:3])
        return (None, None, None, None, ct_t0, ct_t1, ct_dt0, *grads[3:])


def whole_solve_odeint(func: Callable, y0: torch.Tensor, t0, t1, leaves, *,
                       rtol: float, atol: float, max_steps: int,
                       controller: Optional[PIController] = None) -> ODESolution:
    """Integrate ``MLPDynamics`` with leaves ``(W1, b1, W2, b2)`` from ``t0``
    to ``t1`` in one forward launch and one backward launch.

    ``func(t, y, leaves)`` is the model-level dynamics, used for
    ``odeint``'s prologue (``f(t0, y0)`` and the initial step), so the
    solution, its NFE (``2 + 6 * trial steps``) and its telemetry are those
    ``ops.ode.odeint`` returns."""
    ctrl = controller or PIController.for_order(TSIT5.order)
    leaves = tuple(leaves)
    t0, t1, f_init, dt_init = solve_prologue(func, y0, t0, t1, leaves, rtol, atol)
    (y1, tel_t, tel_dt, tel_e, tel_g, acc, live, counts) = WholeSolveFn.apply(
        ctrl, max_steps, float(rtol), float(atol), t0, t1, dt_init, y0, f_init,
        *leaves)
    naccept, nreject, done = counts.tolist()
    return ODESolution(y1=y1, stats=solve_stats(naccept, nreject, done),
                       telemetry=StepTelemetry(tel_t, tel_dt, tel_e, tel_g, acc,
                                               live))
