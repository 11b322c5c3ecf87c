"""Adaptive Tsit5 integration with telemetry and a fast adjoint.

Counterpart of ``regneuralde_tpu/ops/ode.py``, restricted to what the MNIST
Neural-ODE and latent-ODE training steps run: Tsit5 with a *normed* stage
sweep (the error and stiffness norms arrive as three sums of squares, see
``NormedSweep``), the fast adjoint solve (``_make_fast_adjoint_solve``
there, ``FastAdjointSolve`` here), a forward-only ``"while"`` mode, and
dense output at ``saveat`` stamps by cubic Hermite interpolation on each
accepted step (``_hermite_eval``).

The adaptive loop runs on the host: each trial step reads its accept and
done flags back, one host sync per trial step. The forward stores, per
trial step, ``t, dt, qold``, the three norm sums and the ``y, f0`` rows, so
the backward runs one sweep backward per step (the K2 kernel on the card)
and no forward replay. A ``saveat`` solve also keeps each accepted step's
``y_new, k_last`` (the Hermite primals), and the backward pulls the
interpolation back from them (``hermite_pullback``). The scalar chain
(controller, time update, telemetry; ``_post``) is differentiated with
``torch.autograd.grad`` on 0-d tensors. ``post_bwd`` is its hand pullback,
and ``adjoint_step`` the rest of one reverse step; they, the saver and the
Hermite pullback are shared with ``ops.whole_solve``.

Every solver decision matches the JAX package: the PI controller with its
deadband, the ``span`` clamp, the ``is_last`` step to ``t1``, telemetry
rows ``t, dt, eest, eigen_est, accepted, live`` of length ``max_steps``,
and ``nfe = 2 + 6 * (naccept + nreject)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from regneuralde_tpu_torch.ops.controller import _EEST_FLOOR, PIController, initial_step_size
from regneuralde_tpu_torch.ops.tableaus import TSIT5


class StepTelemetry(NamedTuple):
    """Per-trial-step solver internals, each of shape ``(max_steps,)``, or
    ``(batch, max_steps)`` per sample."""

    t: torch.Tensor  # endpoint of the trial step
    dt: torch.Tensor  # dt used for the trial step
    eest: torch.Tensor  # tolerance-normalized local error estimate
    eigen_est: torch.Tensor  # stiffness estimate
    accepted: torch.Tensor  # bool
    live: torch.Tensor  # bool


class ODEStats(NamedTuple):
    """Solver counts: Python numbers for the whole batch, or ``(batch,)``
    tensors per sample (``ops.per_sample``)."""

    nfe: Union[int, torch.Tensor]
    naccept: Union[int, torch.Tensor]
    nreject: Union[int, torch.Tensor]
    success: Union[bool, torch.Tensor]  # reached t1 within max_steps


class ODESolution(NamedTuple):
    y1: torch.Tensor
    stats: ODEStats
    telemetry: StepTelemetry
    ys: Optional[torch.Tensor] = None  # states at ``ts``, (len(ts),) + y1.shape
    ts: Optional[torch.Tensor] = None  # the saveat stamps


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
# Dense output at ``saveat``.
# ---------------------------------------------------------------------------


def _hermite_eval(theta, h, y0, y1, f0, f1):
    """Cubic Hermite interpolation on one step; ``theta`` has shape (S,)
    and the result ``(S,) + y0.shape``."""
    th = theta.to(y0.dtype).reshape((-1,) + (1,) * y0.dim())
    hh = h.to(y0.dtype)
    dy = y1 - y0
    return ((1 - th) * y0 + th * y1
            + th * (th - 1) * ((1 - 2 * th) * dy + (th - 1) * hh * f0 + th * hh * f1))


def _interp(saveat, t, dt_eff, y, y_new, f0, k_last):
    theta = (saveat - t) / torch.where(dt_eff == 0, torch.ones_like(dt_eff), dt_eff)
    return _hermite_eval(theta, dt_eff, y, y_new, f0, k_last)


def _interp_bwd(saveat, primals, ct):
    """Autograd of ``_interp`` over ``primals = (t, dt_eff, y, y_new, f0,
    k_last)``: their cotangents for the rows' cotangent ``ct``."""
    prim = [x.detach().requires_grad_(True) for x in primals]
    with torch.enable_grad():
        return torch.autograd.grad(_interp(saveat, *prim), prim, grad_outputs=ct)


def _save_window(saveat, t, t_end, tdir, like):
    """The stamps an accepted step from ``t`` to ``t_end`` writes, shaped
    to broadcast against ``(S,) + like.shape``."""
    win = ((saveat - t) * tdir > 0) & ((saveat - t_end) * tdir <= 0)
    return win.reshape((-1,) + (1,) * like.dim())


def hermite_pullback(saveat, tdir, t1, is_last, primals, ct_ys):
    """The pullback of one accepted step's ``saveat`` writes from its
    primals ``(t, dt_eff, y, y_new, f0, k_last)``: the window mask hands
    each row's cotangent to the one step that wrote it (a rejected step
    writes none), and autograd of ``_interp`` pulls it back. Returns the
    primals' cotangents and ``ct_ys`` with the step's rows zeroed."""
    t, dt_eff, y = primals[:3]
    t_end = torch.where(is_last, t1, t + dt_eff)
    win = _save_window(saveat, t, t_end, tdir, y)
    zero = torch.zeros_like(ct_ys)
    interp = _interp_bwd(saveat, primals, torch.where(win, ct_ys, zero))
    return interp, torch.where(win, zero, ct_ys)


def saveat_rows(saveat, t0, t1, y0):
    """``saveat`` as a tensor of the time type, and the rows' initial
    values ``ys_init``: ``y0`` at stamps at or before ``t0`` (OrdinaryDiffEq
    saves u0 when saveat contains t0), zero elsewhere; without ``saveat``
    ``(None, an empty (0,) + y0.shape tensor)``."""
    if saveat is None:
        return None, y0.new_zeros((0,) + tuple(y0.shape))
    saveat = torch.as_tensor(saveat, dtype=t0.dtype, device=y0.device)
    at_start = ((saveat - t0) * torch.sign(t1 - t0) <= 0).reshape(
        (-1,) + (1,) * y0.dim())
    return saveat, torch.where(at_start, y0.unsqueeze(0),
                               y0.new_zeros((saveat.shape[0],) + tuple(y0.shape)))


class _HermiteSaver:
    """The ``saveat`` rows of one solve. Each accepted trial step writes
    the stamps in its window ``(t, t_end]`` by Hermite interpolation; rows
    at or before ``t0`` keep ``ys_init`` (``y0``). With ``keep`` it also
    records each accepted step's ``(y_new, k_last)`` for the backward."""

    def __init__(self, saveat, tdir, ys_init, keep):
        self.saveat, self.tdir, self.ys = saveat, tdir, ys_init
        self.primals = {} if keep else None

    def __call__(self, i, t, dt_eff, t_end, y, f0, res):
        win = _save_window(self.saveat, t, t_end, self.tdir, y)
        y_interp = _interp(self.saveat, t, dt_eff, y, res.y_new, f0, res.k_last)
        self.ys = torch.where(win, y_interp, self.ys)
        if self.primals is not None:
            self.primals[i] = (res.y_new, res.k_last)


# ---------------------------------------------------------------------------
# The plain normed sweep over any dynamics callable.
# ---------------------------------------------------------------------------


def plain_normed_sweep(func, t, dt, y, k1, args, rtol, atol) -> NormedSweep:
    """Normed Tsit5 trial step of ``func(t, y, args)`` in plain torch ops."""
    y_new, k_last, err2, num2, den2 = normed_terms(func, t, dt, y, k1, args, rtol, atol)
    return NormedSweep(y_new, k_last, torch.sum(err2), torch.sum(num2), torch.sum(den2))


def normed_terms(func, t, dt, y, k1, args, rtol, atol):
    """``plain_normed_sweep`` before its three sums: ``(y_new, k_last)`` and
    the per-element squares ``(err / denom)^2``, ``(k_last - k_prev)^2``,
    ``(y_new - g_prev)^2``."""
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
    return y_stage, ks[-1], scaled * scaled, dk * dk, dg * dg


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


def _post(ctrl, count, t, dt_eff, qold, e, n, d, t1, span, is_last):
    """The scalar chain of one trial step after its norm sums (the
    ``post`` of ``regneuralde_tpu/ops/pallas_solve.py``): ``(t_new,
    dt_next, qold_next, t_end, eest, eigen_est)``."""
    eest, eigen = _normed_scalars(e, n, d, count)
    accept = eest <= 1.0
    dt_next, qold_next = ctrl.propose(dt_eff, eest, qold, accept)
    dt_next = torch.sign(dt_next) * torch.minimum(torch.abs(dt_next), span)
    t_end = torch.where(is_last, t1, t + dt_eff)
    t_new = torch.where(accept, t_end, t)
    return t_new, dt_next, qold_next, t_end, eest, eigen


def _max_grad(a, b, g):
    """Autograd's ``torch.maximum(a, b)`` pullback to ``a``: all of ``g``
    where ``a`` wins, half of it on a tie."""
    return torch.where(a > b, g, torch.where(a == b, g / 2, torch.zeros_like(g)))


def _min_grad(a, b, g):
    """Autograd's ``torch.minimum(a, b)`` pullback to ``a``."""
    return torch.where(a < b, g, torch.where(a == b, g / 2, torch.zeros_like(g)))


def post_bwd(ctrl, count, t, dt_eff, qold, e, n, d, t1, span, is_last, accept,
             cts):
    """Hand pullback of ``_post``: ``cts`` are the cotangents of its six
    outputs; returns those of ``(t, dt_eff, qold, e, n, d, t1, span)``.

    The tie conventions are autograd's (``maximum``/``minimum`` split a
    tie in half, ``sign`` has a zero derivative, ``abs`` at 0 too), so it
    matches ``torch.autograd`` of ``_post``. ``accept`` is the stored
    flag. ``csrc/whole_solve.cu`` (``post_bwd``) runs the same algebra."""
    c_tnew, c_dtn, c_qn, c_tend, c_eest, c_eig = cts
    zero = torch.zeros_like(e)
    one = torch.ones_like(e)
    # forward recompute
    pe, pn, pd = e > 0, n > 0, d > 0
    eest = torch.where(pe, torch.sqrt(torch.where(pe, e, one) / count), zero)
    eig_num = torch.where(pn, torch.sqrt(torch.where(pn, n, one)), zero)
    eig_den = torch.where(pd, torch.sqrt(torch.where(pd, d, one)), zero)
    tiny = one * 1e-30
    mden = torch.maximum(eig_den, tiny)
    floor = one * _EEST_FLOOR
    es = torch.maximum(eest, floor)
    q11 = es ** ctrl.beta1
    qb = qold ** ctrl.beta2
    q = q11 / qb
    qg = q / ctrl.gamma
    lo, hi = one / ctrl.qmax, one / ctrl.qmin
    mx = torch.maximum(qg, lo)
    qa0 = torch.minimum(mx, hi)
    if ctrl.qsteady_max > 1.0:
        in_band = (qa0 >= 1.0) & (qa0 <= ctrl.qsteady_max)
        qa = torch.where(in_band, one, qa0)
    else:
        in_band = torch.zeros_like(accept)
        qa = qa0
    r = q11 / ctrl.gamma
    q_rej = torch.minimum(hi, r)
    dt0 = torch.where(accept, dt_eff / qa, dt_eff / q_rej)
    s = torch.sign(dt0)
    a = torch.abs(dt0)

    # t_new = where(accept, t_end, t); t_end = where(is_last, t1, t + dt_eff)
    g_tend = c_tend + torch.where(accept, c_tnew, zero)
    g_t = torch.where(accept, zero, c_tnew)
    g_t1 = torch.where(is_last, g_tend, zero)
    g_lin = torch.where(is_last, zero, g_tend)
    g_t = g_t + g_lin
    g_dteff = g_lin
    # dt_next = sign(dt0) * minimum(|dt0|, span)
    g_m = c_dtn * s
    g_dt0 = _min_grad(a, span, g_m) * s
    g_span = _min_grad(span, a, g_m)
    # qold_next = where(accept, maximum(eest, qoldinit), qold)
    g_qold = torch.where(accept, zero, c_qn)
    g_eest = c_eest + _max_grad(eest, one * ctrl.qoldinit,
                                torch.where(accept, c_qn, zero))
    # dt0 = where(accept, dt_eff / qa, dt_eff / q_rej)
    g_acc = torch.where(accept, g_dt0, zero)
    g_rej = torch.where(accept, zero, g_dt0)
    g_dteff = g_dteff + g_acc / qa + g_rej / q_rej
    g_qa = -g_acc * ((dt_eff / qa) / qa)
    g_qrej = -g_rej * ((dt_eff / q_rej) / q_rej)
    g_q11 = _min_grad(r, hi, g_qrej) / ctrl.gamma
    g_qa0 = torch.where(in_band, zero, g_qa)
    g_q = _max_grad(qg, lo, _min_grad(mx, hi, g_qa0)) / ctrl.gamma
    g_q11 = g_q11 + g_q / qb
    g_qb = -g_q * ((q11 / qb) / qb)
    g_qold = g_qold + g_qb * (ctrl.beta2 * qold ** (ctrl.beta2 - 1))
    g_es = g_q11 * (ctrl.beta1 * es ** (ctrl.beta1 - 1))
    g_eest = g_eest + _max_grad(eest, floor, g_es)
    # eigen = where(eig_den > 0, eig_num / maximum(eig_den, 1e-30), 0)
    g_ratio = torch.where(eig_den > 0, c_eig, zero)
    g_num = g_ratio / mden
    g_den = _max_grad(eig_den, tiny, -g_ratio * ((eig_num / mden) / mden))
    g_e = torch.where(pe, (g_eest / (2 * eest)) / count, zero)
    g_n = torch.where(pn, g_num / (2 * eig_num), zero)
    g_d = torch.where(pd, g_den / (2 * eig_den), zero)
    return g_t, g_dteff, g_qold, g_e, g_n, g_d, g_t1, g_span


def _solve_forward(sweep, ctrl, max_steps, t0, t1, dt_init, y0, f0, args,
                   keep_history, on_accept=None):
    """The trial-step loop of ``_make_fast_adjoint_solve._forward``.
    ``on_accept(i, t, dt_eff, t_end, y, f0, res)`` sees each accepted trial
    step ``i`` before the carry moves on (the ``saveat`` writer)."""
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
        t_new, dt_next, qold_next, t_end, eest, eigen_est = _post(
            ctrl, count, t, dt_eff, qold, e, n, d, t1, span, is_last)
        if keep_history:
            hist.append((t, dt, qold, e, n, d, y, f0))
        rows.append((t_end, dt_eff, eest, eigen_est))
        # the one host sync of the trial step
        acc_flag, last_flag = torch.stack((eest <= 1.0, is_last)).tolist()
        accepted.append(acc_flag)
        if acc_flag:
            if on_accept is not None:
                on_accept(len(accepted) - 1, t, dt_eff, t_end, y, f0, res)
            t, y, f0 = t_new, res.y_new, res.k_last
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


class AdjointCarry(NamedTuple):
    """The running cotangents of the reverse walk over the trial steps."""

    ct_t: torch.Tensor
    ct_dt: torch.Tensor
    ct_qold: torch.Tensor
    ct_y: torch.Tensor
    ct_f0: torch.Tensor
    ct_leaves: list
    ct_t1x: torch.Tensor  # direct cotangent of t1
    ct_spanx: torch.Tensor  # cotangent of span = |t1 - t0|

    def finish(self, tdir):
        """``(ct_t0, ct_t1, ct_dt_init, ct_y0, ct_f0_init, *ct_leaves)``."""
        return (self.ct_t - tdir * self.ct_spanx, self.ct_t1x + tdir * self.ct_spanx,
                self.ct_dt, self.ct_y, self.ct_f0, *self.ct_leaves)


def adjoint_step(sweep_bwd, leaves, primals, acc, is_last, dp, ct_tel_dt, carry,
                 interp=None):
    """One trial step of the reverse walk, after the scalar chain's
    pullback ``dp = (t, dt_eff, qold, e, n, d, t1, span)``: route the carry
    by the accept flag (``y_out = where(acc, y_new, y)``, ``f0_out``
    likewise), run the sweep's backward, and pull ``dt_eff = where(is_last,
    t1 - t, dt)`` back. ``primals = (t, dt_eff, y, f0)``. ``interp`` holds
    the cotangents of the step's Hermite interpolation inputs ``(t,
    dt_eff, y, y_new, f0, k_last)`` in a ``saveat`` solve."""
    t_i, dt_eff, y_i, f0_i = primals
    dp_t, dp_dteff, dp_qold, ct_e, ct_n, ct_d, dp_t1, dp_span = dp
    zero = torch.zeros_like(dp_t)
    ct_y, ct_f0 = carry.ct_y, carry.ct_f0
    if acc:
        ct_ynew, ct_y_pass = ct_y, torch.zeros_like(ct_y)
        ct_k7, ct_f0_pass = ct_f0, torch.zeros_like(ct_f0)
    else:
        ct_ynew, ct_y_pass = torch.zeros_like(ct_y), ct_y
        ct_k7, ct_f0_pass = torch.zeros_like(ct_f0), ct_f0
    if interp is not None:
        di_t, di_dteff, di_y, di_ynew, di_f0, di_klast = interp
        ct_ynew = ct_ynew + di_ynew
        ct_k7 = ct_k7 + di_klast
        ct_y_pass = ct_y_pass + di_y
        ct_f0_pass = ct_f0_pass + di_f0
        dp_t = dp_t + di_t
        dp_dteff = dp_dteff + di_dteff

    # ONE sweep backward; the history holds every primal
    k_ct_t, k_ct_dteff, ct_y_k, ct_k1, ct_args_i = sweep_bwd(
        t_i, dt_eff, y_i, f0_i, tuple(leaves), (ct_ynew, ct_k7, ct_e, ct_n, ct_d))

    ct_dteff = dp_dteff + k_ct_dteff.to(zero.dtype) + ct_tel_dt
    return AdjointCarry(
        ct_t=dp_t + k_ct_t.to(zero.dtype) + torch.where(is_last, -ct_dteff, zero),
        ct_dt=torch.where(is_last, zero, ct_dteff),
        ct_qold=dp_qold,
        ct_y=ct_y_pass + ct_y_k,
        ct_f0=ct_f0_pass + ct_k1,
        ct_leaves=[a + b for a, b in zip(carry.ct_leaves, ct_args_i)],
        ct_t1x=carry.ct_t1x + dp_t1 + torch.where(is_last, ct_dteff, zero),
        ct_spanx=carry.ct_spanx + dp_span)


class FastAdjointSolve(torch.autograd.Function):
    """The fast adjoint solve (``ops/ode.py:_make_fast_adjoint_solve``).

    Inputs ``t0, t1, dt_init, y0, f0_init``, the ``saveat`` rows' initial
    values ``ys_init`` (``y0`` at stamps at or before ``t0``, so that their
    cotangent reaches ``y0``; empty without ``saveat``) and the dynamics'
    leaves, so that autograd routes every cotangent to them. Outputs
    ``y1``, the ``saveat`` rows ``ys`` and the telemetry streams ``t, dt,
    eest, eigen_est``, and, not differentiable, the accept and live masks
    and ``(naccept, nreject, done)``.
    """

    @staticmethod
    def forward(ctx, sweep, sweep_bwd, ctrl, max_steps, saveat, t0, t1, dt_init,
                y0, f0_init, ys_init, *leaves):
        saver = None
        if saveat is not None:
            saver = _HermiteSaver(saveat, torch.sign(t1 - t0), ys_init, keep=True)
        y1, rows, accepted, done, hist = _solve_forward(
            sweep, ctrl, max_steps, t0, t1, dt_init, y0, f0_init, leaves,
            keep_history=True, on_accept=saver)
        tel = _telemetry(rows, accepted, max_steps, t0)
        counts = torch.tensor([sum(accepted), len(accepted) - sum(accepted),
                               int(done)])
        ys = ys_init.clone() if saver is None or saver.ys is ys_init else saver.ys
        ctx.mark_non_differentiable(tel.accepted, tel.live, counts)
        ctx.sweep_bwd, ctx.ctrl, ctx.max_steps = sweep_bwd, ctrl, max_steps
        ctx.hist, ctx.accepted, ctx.saver = hist, accepted, saver
        ctx.save_for_backward(t0, t1, y0, f0_init, *leaves)
        return (y1, ys, tel.t, tel.dt, tel.eest, tel.eigen_est, tel.accepted,
                tel.live, counts)

    @staticmethod
    def backward(ctx, ct_y1, ct_ys, ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g, *_):
        t0, t1, y0, f0_init, *leaves = ctx.saved_tensors
        saver = ctx.saver
        if saver is not None and ct_ys is None:
            ct_ys = torch.zeros_like(saver.ys)
        ctrl = ctx.ctrl
        tdir = torch.sign(t1 - t0)
        span = torch.abs(t1 - t0)
        count = float(y0.numel())
        zero = torch.zeros_like(t0)
        ct_tel = [zero.new_zeros(ctx.max_steps) if c is None else c
                  for c in (ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g)]

        def tel_ct(j, i):
            return ct_tel[j][i]

        carry = AdjointCarry(
            zero, zero, zero, torch.zeros_like(y0) if ct_y1 is None else ct_y1,
            torch.zeros_like(f0_init), [torch.zeros_like(x) for x in leaves],
            zero, zero)

        for i in range(len(ctx.hist) - 1, -1, -1):
            t_i, dt_i, qold_i, e_i, n_i, d_i, y_i, f0_i = ctx.hist[i]
            remaining = t1 - t_i
            is_last = (dt_i - remaining) * tdir >= 0
            dt_eff = torch.where(is_last, remaining, dt_i)

            # scalar chain (controller, time update, telemetry)
            prim = [x.detach().requires_grad_(True)
                    for x in (t_i, dt_eff, qold_i, e_i, n_i, d_i, t1, span)]
            with torch.enable_grad():
                outs = _post(ctrl, count, *prim, is_last)
                grads = torch.autograd.grad(
                    outs, prim,
                    grad_outputs=(carry.ct_t, carry.ct_dt, carry.ct_qold,
                                  tel_ct(0, i), tel_ct(2, i), tel_ct(3, i)),
                    allow_unused=True)
            dp = [zero if g is None else g for g in grads]
            interp = None
            if saver is not None and ctx.accepted[i]:
                y_new_i, k_last_i = saver.primals[i]
                interp, ct_ys = hermite_pullback(
                    saver.saveat, tdir, t1, is_last,
                    (t_i, dt_eff, y_i, y_new_i, f0_i, k_last_i), ct_ys)
            carry = adjoint_step(
                ctx.sweep_bwd, leaves, (t_i, dt_eff, y_i, f0_i),
                ctx.accepted[i], is_last, dp, tel_ct(1, i), carry, interp)

        ctx.hist = ctx.saver = None
        ct_t0, ct_t1, ct_dt, ct_y0, ct_f0, *ct_leaves = carry.finish(tdir)
        return (None, None, None, None, None, ct_t0, ct_t1, ct_dt, ct_y0, ct_f0,
                ct_ys, *ct_leaves)


def solve_prologue(func, y0, t0, t1, args, rtol, atol):
    """``odeint``'s prologue: the time scalars as tensors (float32 at
    least), ``f(t0, y0)`` and Hairer's initial step (one more evaluation):
    ``(t0, t1, f_init, dt_init)``."""
    time_dtype = torch.promote_types(y0.dtype, torch.float32)
    t0 = torch.as_tensor(t0, dtype=time_dtype, device=y0.device)
    t1 = torch.as_tensor(t1, dtype=time_dtype, device=y0.device)
    f_init = func(t0, y0, args)
    dt_init, _ = initial_step_size(func, t0, y0, f_init, args, TSIT5.order,
                                   rtol, atol, t1)
    return t0, t1, f_init, dt_init.to(time_dtype)


def solve_stats(naccept, nreject, done) -> ODEStats:
    """NFE: the prologue's two evaluations and six per trial step."""
    return ODEStats(nfe=2 + (TSIT5.num_stages - 1) * (naccept + nreject),
                    naccept=naccept, nreject=nreject, success=bool(done))


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
    saveat=None,
) -> ODESolution:
    """Integrate ``dy/dt = func(t, y, args)`` from ``t0`` to ``t1``.

    ``args`` is a tuple of tensors (the dynamics' leaves); gradients reach
    them, ``y0``, ``t0`` and ``t1``. ``stage_sweep(t, dt, y, k1, args)``
    returns a ``NormedSweep`` and ``stage_sweep_bwd(t, dt, y, k1, args,
    cts)`` its reverse ``(ct_t, ct_dt, ct_y, ct_k1, ct_args)``; without
    them the plain normed sweep over ``func`` and its autograd reverse run.
    ``mode="adjoint"`` is differentiable (the fast adjoint); ``"while"``
    runs the same forward without recording anything for a backward.
    ``saveat``: 1-D stamps at which the solution also holds the
    interpolated states ``ys`` (stamps at or before ``t0`` hold ``y0``).
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
    t0, t1, f_init, dt_init = solve_prologue(func, y0, t0, t1, args, rtol, atol)
    saveat, ys_init = saveat_rows(saveat, t0, t1, y0)

    if mode == "while":
        saver = None
        if saveat is not None:
            saver = _HermiteSaver(saveat, torch.sign(t1 - t0), ys_init, keep=False)
        with torch.no_grad():
            y1, rows, accepted, done, _ = _solve_forward(
                stage_sweep, ctrl, max_steps, t0, t1, dt_init, y0, f_init,
                args, keep_history=False, on_accept=saver)
        tel = _telemetry(rows, accepted, max_steps, t0)
        naccept, nreject = sum(accepted), len(accepted) - sum(accepted)
        ys = None if saver is None else saver.ys
    else:
        (y1, ys, tel_t, tel_dt, tel_e, tel_g, acc, live,
         counts) = FastAdjointSolve.apply(
            stage_sweep, stage_sweep_bwd, ctrl, max_steps, saveat, t0, t1,
            dt_init, y0, f_init, ys_init, *args)
        tel = StepTelemetry(tel_t, tel_dt, tel_e, tel_g, acc, live)
        naccept, nreject, done = counts.tolist()
    return ODESolution(y1=y1, stats=solve_stats(naccept, nreject, done),
                       telemetry=tel, ys=None if saveat is None else ys,
                       ts=saveat)
