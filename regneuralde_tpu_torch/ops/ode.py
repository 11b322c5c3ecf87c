"""Adaptive explicit Runge-Kutta integration with telemetry and its adjoints.

Counterpart of ``regneuralde_tpu/ops/ode.py``: the FSAL tableaus Tsit5,
Dopri5 and Bosh3, a stage sweep in either of JAX's two protocols, the
three modes of ``odeint``, ``dt0``, and dense output at ``saveat`` stamps
by cubic Hermite interpolation on each accepted step (``_hermite_eval``).

A stage sweep ``sweep(t, dt, y, k1, args)`` runs one trial step and returns
either a ``NormedSweep`` (the error and stiffness norms reduced to three
sums of squares, as the step kernels do) or the tuple ``(y_new, k_last,
err, k_prev, g_prev)`` of ``generic_sweep``, the default over ``func``.
``_Stepper`` is one trial step over a carry ``(t, dt, qold, y, f0, ys)``
(JAX's ``_make_step_fn``); accept and reject are ``torch.where``s, so that
a recompute takes the forward's path. The adaptive loop runs on the host
(``_run_steps``): each trial step reads its accept and done flags back,
one host sync per trial step. The modes:

* ``"scan"`` (the default, JAX's gradient oracle): autograd through every
  trial step and its sweep, each step under ``torch.utils.checkpoint`` with
  ``remat``. JAX scans ``max_steps`` steps with a no-op past the end; the
  no-op is the identity in value and gradient, so the host stops issuing
  steps at the end and the telemetry keeps ``max_steps`` rows.
* ``"adjoint"``: with a normed sweep and its backward ``stage_sweep_bwd``,
  the fast adjoint (``_make_fast_adjoint_solve`` there,
  ``FastAdjointSolve`` here). The forward stores, per trial step, ``t, dt,
  qold``, the three norm sums and the ``y, f0`` rows, so the backward runs
  one sweep backward per step and no forward replay; a ``saveat`` solve
  also keeps each accepted step's ``y_new, k_last`` for the Hermite
  pullback (``hermite_pullback``). The scalar chain (``_post``) is
  differentiated with ``torch.autograd.grad``; ``post_bwd`` is its hand
  pullback, and ``adjoint_step`` the rest of one reverse step, shared with
  ``ops.whole_solve``. Otherwise the replay adjoint
  (``_make_adjoint_solve`` there, ``ReplayAdjointSolve`` here): the forward
  stores each trial step's start carry, the backward rebuilds each step
  from it and differentiates it.
* ``"while"``: the same forward, nothing recorded for a backward.

Every solver decision matches the JAX package: the PI controller with its
deadband, the ``span`` clamp, the ``is_last`` step to ``t1``, telemetry
rows ``t, dt, eest, eigen_est, accepted, live`` of length ``max_steps``,
and ``nfe = nfe_init + (stages - 1) * (naccept + nreject)``, ``nfe_init``
2 with Hairer's initial step and 1 with ``dt0``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from regneuralde_tpu_torch.ops.controller import _EEST_FLOOR, PIController, initial_step_size
from regneuralde_tpu_torch.ops.norms import error_ratio, hairer_norm
from regneuralde_tpu_torch.ops.tableaus import TSIT5, ExplicitRKTableau, get_tableau


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
    ``(y_new - g_prev)^2`` of Tsit5's ``generic_sweep``."""
    y_new, k_last, err, k_prev, g_prev = generic_sweep(func, TSIT5, t, dt, y, k1, args)
    scaled = err / (atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol)
    dk = k_last - k_prev
    dg = y_new - g_prev
    return y_new, k_last, scaled * scaled, dk * dk, dg * dg


# ---------------------------------------------------------------------------
# The generic sweep over any FSAL tableau (the tuple protocol).
# ---------------------------------------------------------------------------


def _lincomb(y, dt, coeffs, ks):
    """``y + dt * sum_i coeffs[i] * ks[i]`` over the nonzero coefficients,
    the first of them first (``ops/norms.py`` ``tree_lincomb``)."""
    nz = [(c, k) for c, k in zip(coeffs, ks) if c != 0.0]
    if not nz:
        return y
    acc = nz[0][0] * nz[0][1]
    for c, k in nz[1:]:
        acc = acc + c * k
    return y + dt * acc


def generic_sweep(func, tab: ExplicitRKTableau, t, dt, y, k1, args):
    """One trial step of ``tab`` over ``func(t, y, args)`` in the tuple
    protocol: ``(y_new, k_last, err, k_prev, g_prev)``. FSAL: ``y_new`` is
    the last stage's input and ``k_last`` its derivative, ``k_prev`` and
    ``g_prev`` the stage before's (the stiffness estimate's differences).
    The embedded error is regrouped as ``dt * sum_i btilde_i (k_i - k1)``,
    exact since ``sum(btilde) == 0``: in float32 every summand stays O(dt)
    instead of O(1) stage values cancelling down to the error."""
    n = tab.num_stages
    ks = [k1]
    y_stage = g_prev = y
    for i in range(1, n):
        y_stage = _lincomb(y, dt, tab.a[i - 1], ks)
        ks.append(func(t + tab.c[i] * dt, y_stage, args))
        if i == n - 2:  # tab.a[n - 3] over ks[:n - 2]
            g_prev = y_stage
    err = tab.btilde[1] * (ks[1] - ks[0])
    for c, k in zip(tab.btilde[2:], ks[2:]):
        err = err + c * (k - ks[0])
    return y_stage, ks[-1], dt * err, ks[-2], g_prev


def _estimates(res, y, rtol, atol, count, dtype):
    """``(y_new, k_last, eest, eigen_est)`` of a sweep result in either
    protocol: a ``NormedSweep``, or the tuple ``(y_new, k_last, err,
    k_prev, g_prev)`` whose norms are taken here."""
    if isinstance(res, NormedSweep):
        eest, eigen = _normed_scalars(res.err_ssq.to(dtype), res.eig_num_ssq.to(dtype),
                                      res.eig_den_ssq.to(dtype), count)
        return res.y_new, res.k_last, eest, eigen
    if not (isinstance(res, tuple) and len(res) == 5):
        raise NotImplementedError(
            "a stage sweep returns a NormedSweep or the tuple (y_new, k_last, err, k_prev, "
            "g_prev); JAX's CompSweep and EigenSweep are not ported yet (ROADMAP.md queue 1 "
            "item 9)")
    y_new, k_last, err, k_prev, g_prev = res
    eest = error_ratio(err, y, y_new, rtol, atol).to(dtype)
    eig_num = hairer_norm(k_last - k_prev)
    eig_den = hairer_norm(y_new - g_prev)
    eigen = torch.where(eig_den > 0,
                        eig_num / torch.maximum(eig_den, torch.full_like(eig_den, 1e-30)),
                        torch.zeros_like(eig_den))
    return y_new, k_last, eest, eigen.to(dtype)


# ---------------------------------------------------------------------------
# The solve.
# ---------------------------------------------------------------------------


def _advance(ctrl, t, dt_eff, qold, eest, t1, span, is_last):
    """The controller and the time update of one trial step: ``(t_new,
    dt_next, qold_next, t_end)``."""
    accept = eest <= 1.0
    dt_next, qold_next = ctrl.propose(dt_eff, eest, qold, accept)
    dt_next = torch.sign(dt_next) * torch.minimum(torch.abs(dt_next), span)
    t_end = torch.where(is_last, t1, t + dt_eff)
    t_new = torch.where(accept, t_end, t)
    return t_new, dt_next, qold_next, t_end


def _post(ctrl, count, t, dt_eff, qold, e, n, d, t1, span, is_last):
    """The scalar chain of one trial step after its norm sums (the
    ``post`` of ``regneuralde_tpu/ops/pallas_solve.py``): ``(t_new,
    dt_next, qold_next, t_end, eest, eigen_est)``."""
    eest, eigen = _normed_scalars(e, n, d, count)
    return (*_advance(ctrl, t, dt_eff, qold, eest, t1, span, is_last), eest, eigen)


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


@contextlib.contextmanager
def _matmul_precision(precision):
    """float32 products at ``precision`` (``torch.set_float32_matmul_precision``;
    None keeps the caller's). Entered by every trial step and by the
    adjoints' backwards; a backward runs outside any context the forward
    entered, so ``odeint`` also wraps its graph in a ``_PrecisionScope``.
    The embedded error estimate is a fifth-order cancellation, and TF32
    products would feed it rounding noise that ~1/tol amplifies through the
    controller into the gradients (JAX's reason,
    ``regneuralde_tpu/ops/ode.py:669-680``)."""
    if precision is None:
        yield
        return
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


class _PrecisionMark(torch.autograd.Function):
    """The identity; its backward sets the scope's precision (``on``) or
    restores the caller's."""

    @staticmethod
    def forward(ctx, scope, on, *xs):
        ctx.scope, ctx.on = scope, on
        return xs

    @staticmethod
    def backward(ctx, *cts):
        (ctx.scope.set if ctx.on else ctx.scope.restore)()
        return (None, None, *cts)


class _PrecisionScope:
    """``matmul_precision`` for the backward of a solve's autograd graph:
    the scan's steps, the prologue, the adjoints' inputs. ``inputs`` marks
    the tensors entering the solve and ``outputs`` those leaving it. In the
    backward the outputs' mark sets the precision and the inputs' mark
    restores the caller's, and every node of the solve runs in between: the
    engine runs a node after every node that consumes its output, and of
    the ready nodes the one created last. A backward that never reaches the
    inputs' mark (gradients only of tensors the dynamics close over)
    restores the caller's precision at its end. Nodes the engine runs on
    another device's thread meanwhile see the solve's precision too."""

    def __init__(self, precision):
        self.precision, self.old = precision, None

    def set(self):
        self.old = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(self.precision)
        torch.autograd.Variable._execution_engine.queue_callback(self.restore)

    def restore(self):
        if self.old is not None:
            torch.set_float32_matmul_precision(self.old)
            self.old = None

    def _mark(self, on, xs):
        idx = [i for i, x in enumerate(xs) if isinstance(x, torch.Tensor) and x.requires_grad]
        out = list(xs)
        if idx:
            for i, x in zip(idx, _PrecisionMark.apply(self, on, *(xs[i] for i in idx))):
                out[i] = x
        return out

    def inputs(self, *xs):
        return self._mark(False, xs)

    def outputs(self, *xs):
        return self._mark(True, xs)


class _Stepper(NamedTuple):
    """One trial step of a solve (JAX's ``_make_step_fn``): called on the
    carry ``(t, dt, qold, y, f0, ys)``, then ``t0, t1``, the ``saveat``
    stamps (or None) and the dynamics' leaves, it returns ``(carry', row,
    accept, done)`` with the telemetry row ``(t_end, dt_eff, eest,
    eigen_est)``. ``ys`` holds the ``saveat`` rows (an empty tensor without
    ``saveat``); an accepted step writes the stamps in its window. Accept
    and reject are ``torch.where``s, never a host branch, so that a
    recompute (the checkpointed scan, the replay adjoint) takes the
    forward's path."""

    sweep: Callable
    ctrl: PIController
    rtol: float
    atol: float
    count: float
    precision: Optional[str]

    def __call__(self, t, dt, qold, y, f0, ys, t0, t1, saveat, *args):
        with _matmul_precision(self.precision):
            tdir = torch.sign(t1 - t0)
            span = torch.abs(t1 - t0)
            remaining = t1 - t
            is_last = (dt - remaining) * tdir >= 0
            dt_eff = torch.where(is_last, remaining, dt)
            res = self.sweep(t, dt_eff, y, f0, args)
            y_new, k_last, eest, eigen = _estimates(res, y, self.rtol, self.atol, self.count,
                                                    t.dtype)
            t_new, dt_next, qold_next, t_end = _advance(self.ctrl, t, dt_eff, qold, eest, t1,
                                                        span, is_last)
            accept = eest <= 1.0
            y_out = torch.where(accept, y_new, y)
            f0_out = torch.where(accept, k_last, f0)
            if saveat is not None:
                win = _save_window(saveat, t, t_end, tdir, y) & accept
                ys = torch.where(win, _interp(saveat, t, dt_eff, y, y_new, f0, k_last), ys)
        return ((t_new, dt_next, qold_next, y_out, f0_out, ys), (t_end, dt_eff, eest, eigen),
                accept, accept & is_last)


def _run_steps(step, max_steps, carry, t0, t1, saveat, args, remat=False, hist=None):
    """The trial-step loop on the host, one sync a trial step for its
    accept and done flags: ``(carry, rows, accepted, done)``. ``remat``
    runs each step under ``torch.utils.checkpoint``; ``hist`` collects each
    step's start carry ``(t, dt, qold, y, f0)``."""
    rows, accepted = [], []
    done = bool(torch.abs(t1 - t0) == 0)
    while not done and len(accepted) < max_steps:
        if hist is not None:
            hist.append(carry[:5])
        if remat:
            carry, row, acc, fin = checkpoint(step, *carry, t0, t1, saveat, *args,
                                              use_reentrant=False)
        else:
            carry, row, acc, fin = step(*carry, t0, t1, saveat, *args)
        rows.append(row)
        acc_flag, done = torch.stack((acc, fin)).tolist()
        accepted.append(acc_flag)
    return carry, rows, accepted, done


class ReplayAdjointSolve(torch.autograd.Function):
    """The replay adjoint (``ops/ode.py:_make_adjoint_solve``), for any
    sweep: the exact discrete adjoint through every live trial step, with
    nothing past the end.

    Inputs ``t0, t1, dt_init, y0, f0_init``, the ``saveat`` rows' initial
    values ``ys_init``, the stamps (None without ``saveat``) and the
    leaves; outputs as ``FastAdjointSolve``'s. The forward keeps each trial
    step's start carry ``(t, dt, qold, y, f0)`` (JAX's ``_AdjointHist``: the
    carried FSAL derivative, not a recomputed one) and its accept flag. The
    backward walks the steps in reverse: it rebuilds each from its stored
    carry under autograd (one more sweep) and pulls the carried cotangents
    of ``(t, dt, qold, y, f0, ys)`` and the step's telemetry cotangents
    back through it, summing those of ``t0``, ``t1``, the stamps and the
    leaves. A replayed step that decides accept otherwise than the forward
    did would corrupt the adjoint silently; the backward raises instead.
    Not twice differentiable (``mode="scan"`` is)."""

    @staticmethod
    def forward(ctx, step, max_steps, t0, t1, dt_init, y0, f0_init, ys_init, saveat, *args):
        hist = []
        carry = (t0, dt_init, torch.full_like(t0, step.ctrl.qoldinit), y0, f0_init, ys_init)
        carry, rows, accepted, done = _run_steps(step, max_steps, carry, t0, t1, saveat, args,
                                                 hist=hist)
        tel = _telemetry(rows, accepted, max_steps, t0)
        counts = torch.tensor([sum(accepted), len(accepted) - sum(accepted), int(done)])
        ctx.mark_non_differentiable(tel.accepted, tel.live, counts)
        ctx.step, ctx.max_steps, ctx.hist, ctx.accepted = step, max_steps, hist, accepted
        ctx.save_for_backward(t0, t1, y0, f0_init, ys_init, saveat, *args)
        y1, ys = carry[3], carry[5]
        return (y1.clone() if y1 is y0 else y1, ys.clone() if ys is ys_init else ys,
                tel.t, tel.dt, tel.eest, tel.eigen_est, tel.accepted, tel.live, counts)

    @staticmethod
    def backward(ctx, ct_y1, ct_ys, ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g, *_):
        t0, t1, y0, f0_init, ys_init, saveat, *args = ctx.saved_tensors
        zero = torch.zeros_like(t0)
        ct_tel = [zero.new_zeros(ctx.max_steps) if c is None else c
                  for c in (ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g)]
        cts = [zero, zero, zero, torch.zeros_like(y0) if ct_y1 is None else ct_y1,
               torch.zeros_like(f0_init), torch.zeros_like(ys_init) if ct_ys is None else ct_ys]
        sums = [zero, zero] + [None if x is None else torch.zeros_like(x) for x in (saveat, *args)]
        ys_zero = torch.zeros_like(ys_init)  # the rows' cotangent never reads their value
        flipped = torch.zeros((), dtype=torch.bool, device=t0.device)
        for i in range(len(ctx.hist) - 1, -1, -1):
            prim = [x.detach().requires_grad_(True) for x in (*ctx.hist[i], ys_zero, t0, t1)]
            rest = [None if x is None else x.detach().requires_grad_(True)
                    for x in (saveat, *args)]
            with torch.enable_grad(), _matmul_precision(ctx.step.precision):
                carry, row, acc, _ = ctx.step(*prim, *rest)
                pairs = [(o, c) for o, c in zip((*carry, *row), (*cts, *(c[i] for c in ct_tel)))
                         if o.requires_grad]
                inputs = prim + [x for x in rest if x is not None]
                grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                            grad_outputs=[c for _, c in pairs],
                                            allow_unused=True)
            flipped = flipped | (acc != ctx.accepted[i])
            grads = iter(torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs))
            cts = [next(grads) for _ in range(6)]
            sums = [s if s is None else s + next(grads) for s in sums]
        if flipped.item():
            raise RuntimeError(
                "replay adjoint: a replayed trial step decided accept otherwise than the "
                "forward did; the stage sweep is not deterministic")
        ctx.hist = None
        ct_t, ct_dt, _, ct_y, ct_f0, ct_ys = cts
        ct_t0x, ct_t1, *rest = sums
        return (None, None, ct_t + ct_t0x, ct_t1, ct_dt, ct_y, ct_f0, ct_ys, *rest)


def solve_prologue(func, y0, t0, t1, args, rtol, atol, order=TSIT5.order, dt0=None):
    """``odeint``'s prologue: the time scalars as tensors (float32 at
    least), ``f(t0, y0)`` and the initial step: ``dt0`` towards ``t1``, or
    Hairer's (one more evaluation) for a method of ``order``: ``(t0, t1,
    f_init, dt_init)``."""
    time_dtype = torch.promote_types(y0.dtype, torch.float32)
    t0 = torch.as_tensor(t0, dtype=time_dtype, device=y0.device)
    t1 = torch.as_tensor(t1, dtype=time_dtype, device=y0.device)
    f_init = func(t0, y0, args)
    if dt0 is not None:
        return t0, t1, f_init, torch.as_tensor(dt0, dtype=time_dtype,
                                               device=y0.device) * torch.sign(t1 - t0)
    dt_init, _ = initial_step_size(func, t0, y0, f_init, args, order, rtol, atol, t1)
    return t0, t1, f_init, dt_init.to(time_dtype)


def solve_stats(naccept, nreject, done, num_stages=TSIT5.num_stages, nfe_init=2) -> ODEStats:
    """NFE: the prologue's evaluations (``f(t0, y0)``, and Hairer's probe
    unless ``dt0`` was given) and ``num_stages - 1`` per trial step."""
    return ODEStats(nfe=nfe_init + (num_stages - 1) * (naccept + nreject),
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
    dt0: Optional[float] = None,
    max_steps: int = 256,
    saveat=None,
    controller: Optional[PIController] = None,
    mode: str = "scan",
    remat: bool = True,
    axis_name: Optional[str] = None,
    matmul_precision: Optional[str] = "highest",
    stage_sweep: Optional[Callable] = None,
    stage_sweep_bwd: Optional[Callable] = None,
    compensated_eest: bool = False,
) -> ODESolution:
    """Integrate ``dy/dt = func(t, y, args)`` from ``t0`` to ``t1``.

    ``args`` is a tuple of tensors (the dynamics' leaves); gradients reach
    them, ``y0``, ``t0``, ``t1`` and the ``saveat`` stamps. ``solver``:
    ``"tsit5"``, ``"dopri5"`` or ``"bosh3"``. ``dt0``: the initial step
    (``None``: Hairer's heuristic, one more evaluation). ``stage_sweep(t,
    dt, y, k1, args)`` runs one trial step and returns a ``NormedSweep`` or
    the tuple ``(y_new, k_last, err, k_prev, g_prev)``; without it
    ``generic_sweep`` over ``func`` runs. ``mode``: ``"scan"`` (autograd
    through every trial step, each under ``torch.utils.checkpoint`` with
    ``remat``; twice differentiable through the generic sweep),
    ``"adjoint"`` (the fast adjoint for a normed sweep given with its
    backward ``stage_sweep_bwd(t, dt, y, k1, args, cts) -> (ct_t, ct_dt,
    ct_y, ct_k1, ct_args)``, the replay adjoint otherwise) or ``"while"``
    (the same forward, no backward). ``matmul_precision``: float32 product
    precision inside the solve and its backward (``"highest"``: no TF32;
    ``None`` keeps the caller's). ``saveat``: 1-D stamps at which the
    solution also holds the interpolated states ``ys`` (stamps at or
    before ``t0`` hold ``y0``). Not ported yet, each raising
    ``NotImplementedError``: ``axis_name``, ``compensated_eest``, the stiff
    solvers and pytree states.
    """
    if not isinstance(y0, torch.Tensor):
        raise NotImplementedError("pytree states are not ported yet (ROADMAP.md queue 1 "
                                  "item 4); y0 must be a tensor")
    if axis_name is not None:
        raise NotImplementedError("axis_name (data-parallel step control) is not ported yet "
                                  "(ROADMAP.md queue 1 item 10)")
    if compensated_eest:
        raise NotImplementedError("compensated_eest is not ported yet (ROADMAP.md queue 1 "
                                  "item 9)")
    if solver == "rosenbrock23" or solver.startswith("auto_"):
        raise NotImplementedError(f"solver {solver!r} (the stiff solvers) is not ported yet "
                                  "(ROADMAP.md queue 1 item 9)")
    tab = get_tableau(solver)
    if mode not in ("scan", "adjoint", "while"):
        raise ValueError(f"unknown mode {mode!r}; use 'adjoint', 'scan' or 'while'")
    if stage_sweep_bwd is not None and stage_sweep is None:
        raise ValueError("stage_sweep_bwd needs its stage_sweep")
    if stage_sweep is None:
        stage_sweep = lambda t, dt, y, k1, a: generic_sweep(func, tab, t, dt, y, k1, a)
    ctrl = controller or PIController.for_order(tab.order)
    scope = None
    if matmul_precision is not None and mode != "while" and torch.is_grad_enabled():
        scope = _PrecisionScope(matmul_precision)
        y0, t0, t1, saveat, *args = scope.inputs(y0, t0, t1, saveat, *args)
    args = tuple(args)
    with _matmul_precision(matmul_precision):
        t0, t1, f_init, dt_init = solve_prologue(func, y0, t0, t1, args, rtol, atol,
                                                 tab.order, dt0)
    saveat, ys_init = saveat_rows(saveat, t0, t1, y0)
    step = _Stepper(stage_sweep, ctrl, rtol, atol, float(y0.numel()), matmul_precision)

    if mode == "adjoint" and stage_sweep_bwd is not None:
        def sweep_bwd(*a):
            with _matmul_precision(matmul_precision):
                return stage_sweep_bwd(*a)

        with _matmul_precision(matmul_precision):
            out = FastAdjointSolve.apply(stage_sweep, sweep_bwd, ctrl, max_steps, saveat, t0,
                                         t1, dt_init, y0, f_init, ys_init, *args)
    elif mode == "adjoint":
        out = ReplayAdjointSolve.apply(step, max_steps, t0, t1, dt_init, y0, f_init, ys_init,
                                       saveat, *args)
    if mode == "adjoint":
        y1, ys, tel_t, tel_dt, tel_e, tel_g, acc, live, counts = out
        tel = StepTelemetry(tel_t, tel_dt, tel_e, tel_g, acc, live)
        naccept, nreject, done = counts.tolist()
    else:
        carry = (t0, dt_init, torch.full_like(t0, ctrl.qoldinit), y0, f_init, ys_init)
        with contextlib.nullcontext() if mode == "scan" else torch.no_grad():
            carry, rows, accepted, done = _run_steps(
                step, max_steps, carry, t0, t1, saveat, args,
                remat=mode == "scan" and remat and torch.is_grad_enabled())
        tel = _telemetry(rows, accepted, max_steps, t0)
        y1, ys = carry[3], carry[5]
        naccept, nreject = sum(accepted), len(accepted) - sum(accepted)
    if scope is not None:
        y1, ys, *tel_f = scope.outputs(y1, ys, *tel[:4])
        tel = StepTelemetry(*tel_f, tel.accepted, tel.live)
    stats = solve_stats(naccept, nreject, done, tab.num_stages, 2 if dt0 is None else 1)
    return ODESolution(y1=y1, stats=stats, telemetry=tel,
                       ys=None if saveat is None else ys, ts=saveat)
