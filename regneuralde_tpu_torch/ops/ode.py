"""Adaptive Tsit5 integration with telemetry and a fast adjoint.

Counterpart of ``regneuralde_tpu/ops/ode.py``, restricted to what the MNIST
Neural-ODE training step runs: Tsit5 with a *normed* stage sweep (the
error and stiffness norms arrive as three sums of squares, see
``NormedSweep``), the fast adjoint solve (``_make_fast_adjoint_solve``
there, ``FastAdjointSolve`` here), and a forward-only ``"while"`` mode.

The adaptive loop runs on the host: each trial step reads its accept and
done flags back, one host sync per trial step. The forward stores, per
trial step, ``t, dt, qold``, the three norm sums and the ``y, f0`` rows, so
the backward runs one sweep backward per step (the K2 kernel on the card)
and no forward replay. The scalar chain (controller, time update,
telemetry) is differentiated with ``torch.autograd.grad`` on 0-d tensors.

Every solver decision matches the JAX package: the PI controller with its
deadband, the ``span`` clamp, the ``is_last`` step to ``t1``, telemetry
rows ``t, dt, eest, eigen_est, accepted, live`` of length ``max_steps``,
and ``nfe = 2 + 6 * (naccept + nreject)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from regneuralde_tpu_torch.ops.controller import PIController, initial_step_size
from regneuralde_tpu_torch.ops.tableaus import TSIT5


class StepTelemetry(NamedTuple):
    """Per-trial-step solver internals, each of shape ``(max_steps,)``."""

    t: torch.Tensor  # endpoint of the trial step
    dt: torch.Tensor  # dt used for the trial step
    eest: torch.Tensor  # tolerance-normalized local error estimate
    eigen_est: torch.Tensor  # stiffness estimate
    accepted: torch.Tensor  # bool
    live: torch.Tensor  # bool


class ODEStats(NamedTuple):
    nfe: int
    naccept: int
    nreject: int
    success: bool  # reached t1 within max_steps


class ODESolution(NamedTuple):
    y1: torch.Tensor
    stats: ODEStats
    telemetry: StepTelemetry


class NormedSweep(NamedTuple):
    """A trial step whose norms were reduced to sums of squares."""

    y_new: torch.Tensor
    k_last: torch.Tensor
    err_ssq: torch.Tensor  # sum((err / (atol + max(|y|,|y_new|) rtol))^2)
    eig_num_ssq: torch.Tensor  # sum((k_last - k_prev)^2)
    eig_den_ssq: torch.Tensor  # sum((y_new - g_prev)^2)


def _normed_scalars(err_ssq, num_ssq, den_ssq, count):
    """EEst and eigen_est from the sums of squares, zero-guarded so that
    sqrt's infinite derivative at 0 never meets a zero cotangent."""
    one = torch.ones_like(err_ssq)
    zero = torch.zeros_like(err_ssq)
    eest = torch.where(err_ssq > 0,
                       torch.sqrt(torch.where(err_ssq > 0, err_ssq, one) / count),
                       zero)
    eig_num = torch.where(num_ssq > 0,
                          torch.sqrt(torch.where(num_ssq > 0, num_ssq, one)), zero)
    eig_den = torch.where(den_ssq > 0,
                          torch.sqrt(torch.where(den_ssq > 0, den_ssq, one)), zero)
    eigen_est = torch.where(eig_den > 0,
                            eig_num / torch.maximum(eig_den, one * 1e-30), zero)
    return eest, eigen_est


# ---------------------------------------------------------------------------
# The plain normed sweep over any dynamics callable.
# ---------------------------------------------------------------------------


def plain_normed_sweep(func, t, dt, y, k1, args, rtol, atol) -> NormedSweep:
    """Normed Tsit5 trial step of ``func(t, y, args)`` in plain torch ops."""
    tab = TSIT5
    ks = [k1]
    y_stage = y
    g_prev = y
    for i in range(1, 7):
        acc = tab.a[i - 1][0] * ks[0]
        for c, k in zip(tab.a[i - 1][1:], ks[1:]):
            if c != 0.0:
                acc = acc + c * k
        y_stage = y + dt * acc
        ks.append(func(t + tab.c[i] * dt, y_stage, args))
        if i == 5:
            g_prev = y_stage
    err = tab.btilde[1] * (ks[1] - ks[0])
    for c, k in zip(tab.btilde[2:], ks[2:]):
        err = err + c * (k - ks[0])
    err = dt * err
    denom = atol + torch.maximum(torch.abs(y), torch.abs(y_stage)) * rtol
    scaled = err / denom
    dk = ks[-1] - ks[-2]
    dg = y_stage - g_prev
    return NormedSweep(y_stage, ks[-1], torch.sum(scaled * scaled),
                       torch.sum(dk * dk), torch.sum(dg * dg))


def plain_normed_sweep_bwd(func, t, dt, y, k1, args, cts, rtol, atol):
    """Reverse of ``plain_normed_sweep`` by autograd of a recompute:
    ``(ct_t, ct_dt, ct_y, ct_k1, ct_args)``."""
    inputs = [x.detach().requires_grad_(True) for x in (t, dt, y, k1, *args)]
    with torch.enable_grad():
        out = plain_normed_sweep(func, inputs[0], inputs[1], inputs[2],
                                 inputs[3], tuple(inputs[4:]), rtol, atol)
        grads = torch.autograd.grad(tuple(out), inputs, grad_outputs=cts,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    return grads[0], grads[1], grads[2], grads[3], tuple(grads[4:])


# ---------------------------------------------------------------------------
# The solve.
# ---------------------------------------------------------------------------


def _solve_forward(sweep, ctrl, max_steps, t0, t1, dt_init, y0, f0, args,
                   keep_history):
    """The trial-step loop of ``_make_fast_adjoint_solve._forward``."""
    tdir = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)
    count = float(y0.numel())
    t, dt, y = t0, dt_init, y0
    qold = torch.full_like(t0, ctrl.qoldinit)
    rows = []  # per trial step: tel_t, dt_eff, eest, eigen_est
    accepted = []
    hist = []
    done = bool(span == 0)
    while not done and len(accepted) < max_steps:
        remaining = t1 - t
        is_last = (dt - remaining) * tdir >= 0
        dt_eff = torch.where(is_last, remaining, dt)
        res = sweep(t, dt_eff, y, f0, args)
        e, n, d = (res.err_ssq.to(t.dtype), res.eig_num_ssq.to(t.dtype),
                   res.eig_den_ssq.to(t.dtype))
        eest, eigen_est = _normed_scalars(e, n, d, count)
        accept = eest <= 1.0
        dt_next, qold_next = ctrl.propose(dt_eff, eest, qold, accept)
        dt_next = torch.sign(dt_next) * torch.minimum(torch.abs(dt_next), span)
        t_end = torch.where(is_last, t1, t + dt_eff)
        if keep_history:
            hist.append((t, dt, qold, e, n, d, y, f0))
        rows.append((t_end, dt_eff, eest, eigen_est))
        # the one host sync of the trial step
        acc_flag, last_flag = torch.stack((accept, is_last)).tolist()
        accepted.append(acc_flag)
        if acc_flag:
            t, y, f0 = t_end, res.y_new, res.k_last
        dt, qold = dt_next, qold_next
        done = acc_flag and last_flag
    return y, rows, accepted, done, hist


def _telemetry(rows, accepted, max_steps, like):
    n = len(rows)
    pad = max_steps - n
    cols = []
    for j in range(4):
        vals = [r[j].reshape(()) for r in rows]
        col = torch.stack(vals) if vals else like.new_zeros((0,))
        cols.append(torch.cat([col, like.new_zeros((pad,))]))
    acc = torch.zeros(max_steps, dtype=torch.bool, device=like.device)
    acc[:n] = torch.tensor(accepted, dtype=torch.bool)
    live = torch.zeros(max_steps, dtype=torch.bool, device=like.device)
    live[:n] = True
    return StepTelemetry(*cols, accepted=acc, live=live)


class FastAdjointSolve(torch.autograd.Function):
    """The fast adjoint solve (``ops/ode.py:_make_fast_adjoint_solve``).

    Inputs ``t0, t1, dt_init, y0, f0_init`` and the dynamics' leaves, so
    that autograd routes every cotangent to them. Outputs ``y1`` and the
    telemetry streams ``t, dt, eest, eigen_est``, and, not differentiable,
    the accept and live masks and ``(naccept, nreject, done)``.
    """

    @staticmethod
    def forward(ctx, sweep, sweep_bwd, ctrl, max_steps, t0, t1, dt_init, y0,
                f0_init, *leaves):
        y1, rows, accepted, done, hist = _solve_forward(
            sweep, ctrl, max_steps, t0, t1, dt_init, y0, f0_init, leaves,
            keep_history=True)
        tel = _telemetry(rows, accepted, max_steps, t0)
        counts = torch.tensor([sum(accepted), len(accepted) - sum(accepted),
                               int(done)])
        ctx.mark_non_differentiable(tel.accepted, tel.live, counts)
        ctx.sweep_bwd, ctx.ctrl, ctx.max_steps = sweep_bwd, ctrl, max_steps
        ctx.hist, ctx.accepted = hist, accepted
        ctx.save_for_backward(t0, t1, y0, f0_init, *leaves)
        return (y1, tel.t, tel.dt, tel.eest, tel.eigen_est, tel.accepted,
                tel.live, counts)

    @staticmethod
    def backward(ctx, ct_y1, ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g, *_):
        t0, t1, y0, f0_init, *leaves = ctx.saved_tensors
        ctrl = ctx.ctrl
        tdir = torch.sign(t1 - t0)
        span = torch.abs(t1 - t0)
        count = float(y0.numel())
        zero = torch.zeros_like(t0)
        ct_tel = [zero.new_zeros(ctx.max_steps) if c is None else c
                  for c in (ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g)]

        def tel_ct(j, i):
            return ct_tel[j][i]

        ct_t, ct_dt, ct_qold = zero, zero, zero
        ct_y = torch.zeros_like(y0) if ct_y1 is None else ct_y1
        ct_f0 = torch.zeros_like(f0_init)
        ct_leaves = [torch.zeros_like(x) for x in leaves]
        ct_t1x, ct_spanx = zero, zero

        def post(t, dt_eff, qold, e, n, d, t1_, span_, is_last):
            eest, eigen = _normed_scalars(e, n, d, count)
            accept = eest <= 1.0
            dt_next, qold_next = ctrl.propose(dt_eff, eest, qold, accept)
            dt_next = torch.sign(dt_next) * torch.minimum(torch.abs(dt_next), span_)
            t_end = torch.where(is_last, t1_, t + dt_eff)
            t_new = torch.where(accept, t_end, t)
            return t_new, dt_next, qold_next, t_end, eest, eigen

        for i in range(len(ctx.hist) - 1, -1, -1):
            t_i, dt_i, qold_i, e_i, n_i, d_i, y_i, f0_i = ctx.hist[i]
            acc = ctx.accepted[i]
            remaining = t1 - t_i
            is_last = (dt_i - remaining) * tdir >= 0
            dt_eff = torch.where(is_last, remaining, dt_i)

            # y_out = where(acc, y_new, y); f0_out likewise
            if acc:
                ct_ynew, ct_y_pass = ct_y, torch.zeros_like(ct_y)
                ct_k7, ct_f0_pass = ct_f0, torch.zeros_like(ct_f0)
            else:
                ct_ynew, ct_y_pass = torch.zeros_like(ct_y), ct_y
                ct_k7, ct_f0_pass = torch.zeros_like(ct_f0), ct_f0

            # scalar chain (controller, time update, telemetry)
            prim = [x.detach().requires_grad_(True)
                    for x in (t_i, dt_eff, qold_i, e_i, n_i, d_i, t1, span)]
            with torch.enable_grad():
                outs = post(*prim, is_last)
                grads = torch.autograd.grad(
                    outs, prim,
                    grad_outputs=(ct_t, ct_dt, ct_qold, tel_ct(0, i),
                                  tel_ct(2, i), tel_ct(3, i)),
                    allow_unused=True)
            (dp_t, dp_dteff, dp_qold, ct_e, ct_n, ct_d, dp_t1, dp_span) = [
                zero if g is None else g for g in grads]

            # ONE sweep backward; the history holds every primal
            k_ct_t, k_ct_dteff, ct_y_k, ct_k1, ct_args_i = ctx.sweep_bwd(
                t_i, dt_eff, y_i, f0_i, tuple(leaves),
                (ct_ynew, ct_k7, ct_e, ct_n, ct_d))

            # dt_eff = where(is_last, t1 - t, dt)
            ct_dteff = dp_dteff + k_ct_dteff.to(zero.dtype) + tel_ct(1, i)
            d_t_pre = torch.where(is_last, -ct_dteff, zero)
            d_dt_pre = torch.where(is_last, zero, ct_dteff)
            d_t1_pre = torch.where(is_last, ct_dteff, zero)

            ct_t = dp_t + k_ct_t.to(zero.dtype) + d_t_pre
            ct_dt = d_dt_pre
            ct_qold = dp_qold
            ct_y = ct_y_pass + ct_y_k
            ct_f0 = ct_f0_pass + ct_k1
            ct_leaves = [a + b for a, b in zip(ct_leaves, ct_args_i)]
            ct_t1x = ct_t1x + dp_t1 + d_t1_pre
            ct_spanx = ct_spanx + dp_span

        ctx.hist = None
        ct_t1 = ct_t1x + tdir * ct_spanx
        ct_t0 = ct_t - tdir * ct_spanx
        return (None, None, None, None, ct_t0, ct_t1, ct_dt, ct_y, ct_f0,
                *ct_leaves)


def odeint(
    func: Callable,
    y0: torch.Tensor,
    t0,
    t1,
    args=(),
    *,
    solver: str = "tsit5",
    rtol: float = 1e-7,
    atol: float = 1e-7,
    max_steps: int = 256,
    controller: Optional[PIController] = None,
    mode: str = "adjoint",
    stage_sweep: Optional[Callable] = None,
    stage_sweep_bwd: Optional[Callable] = None,
) -> ODESolution:
    """Integrate ``dy/dt = func(t, y, args)`` from ``t0`` to ``t1``.

    ``args`` is a tuple of tensors (the dynamics' leaves); gradients reach
    them, ``y0``, ``t0`` and ``t1``. ``stage_sweep(t, dt, y, k1, args)``
    returns a ``NormedSweep`` and ``stage_sweep_bwd(t, dt, y, k1, args,
    cts)`` its reverse ``(ct_t, ct_dt, ct_y, ct_k1, ct_args)``; without
    them the plain normed sweep over ``func`` and its autograd reverse run.
    ``mode="adjoint"`` is differentiable (the fast adjoint); ``"while"``
    runs the same forward without recording anything for a backward.
    """
    if solver != "tsit5":
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet; the port has Tsit5 only")
    if mode == "scan":
        raise NotImplementedError("mode='scan' (the differentiable bounded "
                                  "scan) is not ported yet; use 'adjoint'")
    if mode not in ("adjoint", "while"):
        raise ValueError(f"unknown mode {mode!r}; use 'adjoint' or 'while'")
    if (stage_sweep is None) != (stage_sweep_bwd is None):
        raise ValueError("stage_sweep and stage_sweep_bwd go together")
    if stage_sweep is None:
        stage_sweep = lambda t, dt, y, k1, a: plain_normed_sweep(
            func, t, dt, y, k1, a, rtol, atol)
        stage_sweep_bwd = lambda t, dt, y, k1, a, cts: plain_normed_sweep_bwd(
            func, t, dt, y, k1, a, cts, rtol, atol)
    ctrl = controller or PIController.for_order(TSIT5.order)
    args = tuple(args)

    time_dtype = torch.promote_types(y0.dtype, torch.float32)
    t0 = torch.as_tensor(t0, dtype=time_dtype, device=y0.device)
    t1 = torch.as_tensor(t1, dtype=time_dtype, device=y0.device)
    f_init = func(t0, y0, args)
    dt_init, _ = initial_step_size(func, t0, y0, f_init, args, TSIT5.order,
                                   rtol, atol, t1)
    dt_init = dt_init.to(time_dtype)

    if mode == "while":
        with torch.no_grad():
            y1, rows, accepted, done, _ = _solve_forward(
                stage_sweep, ctrl, max_steps, t0, t1, dt_init, y0, f_init,
                args, keep_history=False)
        tel = _telemetry(rows, accepted, max_steps, t0)
        naccept, nreject = sum(accepted), len(accepted) - sum(accepted)
    else:
        (y1, tel_t, tel_dt, tel_e, tel_g, acc, live,
         counts) = FastAdjointSolve.apply(
            stage_sweep, stage_sweep_bwd, ctrl, max_steps, t0, t1, dt_init,
            y0, f_init, *args)
        tel = StepTelemetry(tel_t, tel_dt, tel_e, tel_g, acc, live)
        naccept, nreject, done = counts.tolist()
    stats = ODEStats(nfe=2 + (TSIT5.num_stages - 1) * (naccept + nreject),
                     naccept=naccept, nreject=nreject, success=bool(done))
    return ODESolution(y1=y1, stats=stats, telemetry=tel)
