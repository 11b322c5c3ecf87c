"""Per-lane-controller batched engine for per-sample adaptive stepping.

Counterpart of ``regneuralde_tpu/ops/per_sample_batched.py``. Every batch
row runs under its own PI controller, but the whole batch advances in
lockstep iterations of one full ``(batch, dim)`` stage sweep:

* controller state is a ``(batch,)`` row each: ``t``, ``dt``, ``qold``,
  ``done``, accept/reject and the tolerance-normalized error norm
  ``EEst_i = rms(err_i / (atol + max(|y_i|, |y_new_i|) rtol))`` along the
  features of row ``i`` only;
* finished lanes freeze (their state stops moving, their telemetry rows
  are ``live=False``); the solve ends when every lane is done or after
  ``max_steps`` iterations;
* time enters the dynamics as a ``(batch,)`` vector (``models.basic._t_col``
  maps it to the time column), so batched dynamics modules run unchanged.

The iteration loop runs on the host with one host sync an iteration, the
test ``any(~done)`` that ends the loop. The trial step is a stage sweep
``(t, dt_eff, y, f0, args) -> (y_new, k_last, err, k_prev, g_prev)`` with
per-lane ``(batch,)`` times and step sizes: ``stage_sweep_lanes`` (the
lane-wise kernel K11 of ``ops.fused_mlp_lanes`` or its plain version), or
without one the traced sweep over ``func``. Every lane runs the sweep each
iteration, a finished lane with ``dt_eff = 0``; the step's outputs are
masked afterwards.

``mode="adjoint"`` is differentiable: ``PerSampleAdjointSolve`` keeps each
iteration's step-start carry and the sweep's five output rows, and its
backward walks the executed iterations in reverse: the per-lane chain after
the sweep (norms, eigen proxy, controller, the ``where`` masks, the Hermite
write) is differentiated by ``torch.autograd.grad`` on ``(batch,)`` rows,
and the sweep by ``stage_sweep_lanes_bwd`` (one K12 launch an iteration;
no forward replay). ``mode="while"`` runs the same forward and records
nothing (JAX maps ``"while"`` to the adjoint forward here, whose outputs are
the same). ``mode="scan"`` is not ported.

``saveat`` is a shared ``(n_save,)`` grid or a per-sample ``(batch,
n_save)`` grid, written densely: every accepted step interpolates all save
points in its window for the whole batch (cubic Hermite, ``ops.ode``'s
interpolant). ``ys`` comes back ``(n_save, batch, dim)``.

Scope: a single 2-D ``(batch, dim)`` state and Tsit5.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from regneuralde_tpu_torch.ops.controller import PIController
from regneuralde_tpu_torch.ops.ode import ODESolution, ODEStats, StepTelemetry
from regneuralde_tpu_torch.ops.tableaus import TSIT5

__all__ = ["odeint_per_sample_batched"]


@contextlib.contextmanager
def _highest_matmul_precision():
    """float32 products in full float32 (no TF32) inside the solve: the
    embedded error estimate is a fifth-order cancellation."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _row_norm(x: torch.Tensor) -> torch.Tensor:
    """Hairer RMS norm along features, per batch row. Both ``where``s are
    load-bearing: a finished lane has ``ssq = 0``, and sqrt's infinite
    derivative there would turn the whole ``(batch,)`` cotangent into NaN."""
    ssq = torch.sum(x * x, dim=-1)
    pos = ssq > 0
    safe = torch.where(pos, ssq, torch.ones_like(ssq))
    return torch.where(pos, torch.sqrt(safe / x.shape[-1]), torch.zeros_like(ssq))


def _per_lane_initial_dt(func, t0, y0, f0, args, order, rtol, atol, t1):
    """Hairer's initial step with every norm taken per lane (one more
    evaluation of ``func``): ``(dt0, f_probe)``, ``dt0`` signed."""
    tdir = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)
    scale = atol + torch.abs(y0) * rtol
    d0 = _row_norm(y0 / scale)
    d1 = _row_norm(f0 / scale)
    tiny = torch.full_like(d0, 1e-30)
    dt0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                      0.01 * d0 / torch.maximum(d1, tiny))
    dt0 = torch.minimum(dt0, span)
    y1 = y0 + (tdir * dt0)[:, None] * f0
    f1 = func(t0 + tdir * dt0, y1, args)
    d2 = _row_norm((f1 - f0) / scale) / torch.maximum(dt0, tiny)
    dmax = torch.maximum(d1, d2)
    dt1 = torch.where(dmax <= 1e-15, torch.maximum(torch.full_like(dt0, 1e-6), dt0 * 1e-3),
                      (0.01 / torch.maximum(dmax, tiny)) ** (1.0 / (order + 1)))
    dt = torch.minimum(torch.minimum(100.0 * dt0, dt1), span)
    return tdir * dt, f1


def traced_sweep_lanes(func, t, dt, y, f0, args):
    """The Tsit5 stage sweep over ``func`` with per-lane ``(batch,)`` times
    and step sizes, in the JAX engine's accumulation order (stage lincombs
    k first, one dt multiply; btilde terms differenced against k1):
    ``(y_new, k_last, err, k_prev, g_prev)``."""
    tab = TSIT5
    de = dt[:, None]

    def lincomb(coeffs, kl):
        nz = [(c, k) for c, k in zip(coeffs, kl) if c != 0.0]
        acc = nz[0][0] * nz[0][1]
        for c, k in nz[1:]:
            acc = acc + c * k
        return y + de * acc

    ks = [f0]
    y_stage = y
    for i in range(1, tab.num_stages):
        y_stage = lincomb(tab.a[i - 1], ks)
        ks.append(func(t + tab.c[i] * dt, y_stage, args))
    g_prev = lincomb(tab.a[tab.num_stages - 3], ks[: tab.num_stages - 2])
    err = sum(c * (k - ks[0]) for c, k in zip(tab.btilde[1:], ks[1:]))
    return y_stage, ks[-1], de * err, ks[-2], g_prev


def traced_sweep_lanes_bwd(func, t, dt, y, f0, args, cts):
    """Reverse of ``traced_sweep_lanes`` by autograd of a recompute:
    ``(ct_t, ct_dt, ct_y, ct_f0, ct_args)``."""
    inputs = [x.detach().requires_grad_(True) for x in (t, dt, y, f0, *args)]
    with torch.enable_grad():
        out = traced_sweep_lanes(func, inputs[0], inputs[1], inputs[2], inputs[3],
                                 tuple(inputs[4:]))
        grads = torch.autograd.grad(out, inputs, grad_outputs=cts, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    return grads[0], grads[1], grads[2], grads[3], tuple(grads[4:])


class _Step(NamedTuple):
    """One iteration's outputs (``_chain``)."""

    t: torch.Tensor
    dt: torch.Tensor
    qold: torch.Tensor
    y: torch.Tensor
    f0: torch.Tensor
    done: torch.Tensor
    ys: Optional[torch.Tensor]
    accept: torch.Tensor
    live: torch.Tensor
    tel: tuple  # (t_end, dt_eff, eest, eigen_est), zero on finished lanes


def _dt_eff(t, dt, t1v, tdir):
    """``(is_last, dt_eff)``: the step is clipped to land on ``t1``."""
    remaining = t1v - t
    is_last = (dt - remaining) * tdir >= 0
    return is_last, torch.where(is_last, remaining, dt)


def _chain(ctrl, rtol, atol, t, dt, dt_eff, is_last, qold, y, f0c, done, ys_buf, t0v, t1v,
           saveat, sw) -> _Step:
    """The per-lane step after the sweep ``sw = (y_new, k_last, err, k_prev,
    g_prev)``: norms, eigen proxy, controller, the finished-lane masks and
    the Hermite write (``_make_step_core``'s ``core`` past its sweep)."""
    y_new, k_last, err, k_prev, g_prev = sw
    tdir = torch.sign(t1v - t0v)
    span = torch.abs(t1v - t0v)
    live = ~done
    zero = torch.zeros_like(t)
    scaled = err / (atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol)
    eest = _row_norm(scaled)
    eig_num = _row_norm(k_last - k_prev)
    eig_den = _row_norm(y_new - g_prev)
    eigen_est = torch.where(eig_den > 0,
                            eig_num / torch.maximum(eig_den, torch.full_like(eig_den, 1e-30)),
                            zero)
    accept = eest <= 1.0
    dt_next, qold_next = ctrl.propose(dt_eff, eest, qold, accept)
    dt_next = torch.sign(dt_next) * torch.minimum(torch.abs(dt_next), span)

    upd = accept & live
    t_end = torch.where(is_last, t1v, t + dt_eff)
    ys_out = ys_buf
    if saveat is not None:
        win = (upd[:, None] & ((saveat - t[:, None]) * tdir[:, None] > 0)
               & ((saveat - t_end[:, None]) * tdir[:, None] <= 0))
        de = dt_eff[:, None]
        th = ((saveat - t[:, None]) / torch.where(de == 0, torch.ones_like(de), de))[:, :, None]
        hh = dt_eff[:, None, None]
        yb, ynb = y[:, None, :], y_new[:, None, :]
        dy = ynb - yb
        yi = ((1 - th) * yb + th * ynb
              + th * (th - 1) * ((1 - 2 * th) * dy + (th - 1) * hh * f0c[:, None, :]
                                 + th * hh * k_last[:, None, :]))
        ys_out = torch.where(win[:, :, None], yi, ys_buf)
    return _Step(
        t=torch.where(upd, t_end, t),
        dt=torch.where(live, dt_next, dt),
        qold=torch.where(live, qold_next, qold),
        y=torch.where(upd[:, None], y_new, y),
        f0=torch.where(upd[:, None], k_last, f0c),
        done=done | (accept & is_last & live),
        ys=ys_out, accept=accept, live=live,
        tel=(torch.where(live, t_end, zero), torch.where(live, dt_eff, zero),
             torch.where(live, eest, zero), torch.where(live, eigen_est, zero)))


class _Engine(NamedTuple):
    sweep: Callable  # (t, dt_eff, y, f0, args) -> (y_new, k_last, err, k_prev, g_prev)
    sweep_bwd: Optional[Callable]  # (t, dt_eff, y, f0, args, cts) -> (ct_t, ct_dt, ct_y, ct_f0, ct_args)
    ctrl: PIController
    rtol: float
    atol: float
    max_steps: int


def _solve_forward(eng, t0v, t1v, dt_init, y0, f0, ys_init, saveat, args, keep):
    """The iteration loop. Returns the final carry, the telemetry rows, the
    accept counts and, with ``keep``, each iteration's step-start carry and
    sweep outputs."""
    tdir = torch.sign(t1v - t0v)
    t, dt, y, f0c, ys = t0v, dt_init, y0, f0, ys_init
    qold = torch.full_like(t0v, eng.ctrl.qoldinit)
    done = torch.zeros(t0v.shape, dtype=torch.bool, device=t0v.device)
    na = torch.zeros(t0v.shape, dtype=torch.int64, device=t0v.device)
    nr = torch.zeros_like(na)
    rows, hist = [], []
    for _ in range(eng.max_steps):
        is_last, dt_eff = _dt_eff(t, dt, t1v, tdir)
        sw = tuple(eng.sweep(t, dt_eff, y, f0c, args))
        step = _chain(eng.ctrl, eng.rtol, eng.atol, t, dt, dt_eff, is_last, qold, y, f0c,
                      done, ys, t0v, t1v, saveat, sw)
        if keep:
            hist.append((t, dt, qold, y, f0c, done, sw))
        rows.append((*step.tel, step.accept & step.live, step.live))
        na = na + (step.accept & step.live)
        nr = nr + (~step.accept & step.live)
        t, dt, qold, y, f0c, done, ys = (step.t, step.dt, step.qold, step.y, step.f0,
                                         step.done, step.ys)
        if bool(done.all()):  # the one host sync of the iteration
            break
    return (y, ys, done, na, nr), rows, hist


def _telemetry(rows, max_steps):
    """``(batch, max_steps)`` streams from the iterations' ``(batch,)`` rows,
    zero (and not live) past the last iteration."""
    pad = max_steps - len(rows)
    cols = []
    for j in range(6):
        col = torch.stack([r[j] for r in rows], dim=1)
        cols.append(torch.cat([col, col.new_zeros((col.shape[0], pad))], dim=1))
    return StepTelemetry(*cols)


class PerSampleAdjointSolve(torch.autograd.Function):
    """The adjoint engine (``_make_adjoint_solve``). Inputs ``t0v, t1v,
    dt_init, y0, f0`` (all per lane), the ``saveat`` rows' initial values
    ``ys_init`` (``(batch, n_save, dim)``, empty without ``saveat``), the
    ``(batch, n_save)`` grid (or None) and the dynamics' leaves. Outputs
    ``y1``, ``ys``, the telemetry streams ``t, dt, eest, eigen_est`` and, not
    differentiable, the accept and live masks, ``naccept``, ``nreject`` and
    ``done``."""

    @staticmethod
    def forward(ctx, eng, t0v, t1v, dt_init, y0, f0, ys_init, saveat, *leaves):
        has_saveat = saveat is not None
        (y1, ys, done, na, nr), rows, hist = _solve_forward(
            eng, t0v, t1v, dt_init, y0, f0, ys_init if has_saveat else None, saveat,
            leaves, keep=True)
        tel = _telemetry(rows, eng.max_steps)
        ys = ys.clone() if has_saveat and ys is ys_init else ys
        ctx.eng, ctx.hist, ctx.has_saveat = eng, hist, has_saveat
        ctx.save_for_backward(t0v, t1v, y0, f0, ys_init, saveat, *leaves)
        ctx.mark_non_differentiable(tel.accepted, tel.live, na, nr, done)
        return (y1, ys_init.clone() if ys is None else ys, tel.t, tel.dt, tel.eest,
                tel.eigen_est, tel.accepted, tel.live, na, nr, done)

    @staticmethod
    def backward(ctx, ct_y1, ct_ys, ct_tt, ct_tdt, ct_te, ct_tg, *_):
        t0v, t1v, y0, f0_init, ys_init, saveat, *leaves = ctx.saved_tensors
        eng = ctx.eng
        with _highest_matmul_precision():
            grads = _adjoint_walk(eng, ctx.hist, t0v, t1v, y0, f0_init, ys_init, saveat,
                                  leaves, ct_y1, ct_ys if ctx.has_saveat else None,
                                  (ct_tt, ct_tdt, ct_te, ct_tg))
        ctx.hist = None
        return (None, *grads)


def _adjoint_walk(eng, hist, t0v, t1v, y0, f0_init, ys_init, saveat, leaves, ct_y1, ct_ys,
                  ct_tel):
    """The reverse walk over the executed iterations: per iteration the
    autograd of ``_chain`` (with ``dt_eff`` and the sweep's outputs as its
    inputs), the sweep's backward, and ``dt_eff``'s pullback. Returns the
    cotangents of ``(t0v, t1v, dt_init, y0, f0, ys_init, saveat, *leaves)``."""
    zrow = torch.zeros_like(t0v)
    ct_tel = [torch.zeros(t0v.shape[0], eng.max_steps, dtype=t0v.dtype, device=t0v.device)
              if c is None else c for c in ct_tel]
    ct_t, ct_dt, ct_qold = zrow, zrow, zrow
    ct_y = torch.zeros_like(y0) if ct_y1 is None else ct_y1
    ct_f0 = torch.zeros_like(f0_init)
    has_saveat = saveat is not None
    if has_saveat and ct_ys is None:
        ct_ys = torch.zeros_like(ys_init)
    ct_sa = torch.zeros_like(saveat) if has_saveat else None
    ct_t0x, ct_t1x = zrow, zrow
    ct_leaves = [torch.zeros_like(x) for x in leaves]
    tdir = torch.sign(t1v - t0v)

    for i in range(len(hist) - 1, -1, -1):
        t, dt, qold, y, f0c, done, sw = hist[i]
        is_last, dt_eff = _dt_eff(t, dt, t1v, tdir)
        prim = [x.detach().requires_grad_(True)
                for x in (t, dt, dt_eff, qold, y, f0c, t0v, t1v, *sw)]
        ys_buf = sa = None
        if has_saveat:
            ys_buf = torch.zeros_like(ys_init).requires_grad_(True)
            sa = saveat.detach().requires_grad_(True)
        with torch.enable_grad():
            step = _chain(eng.ctrl, eng.rtol, eng.atol, *prim[:3], is_last, prim[3],
                          prim[4], prim[5], done, ys_buf, prim[6], prim[7], sa,
                          tuple(prim[8:]))
            outs = [step.t, step.dt, step.qold, step.y, step.f0, *step.tel]
            cts = [ct_t, ct_dt, ct_qold, ct_y, ct_f0, *(c[:, i] for c in ct_tel)]
            inputs = list(prim)
            if has_saveat:
                outs.append(step.ys)
                cts.append(ct_ys)
                inputs += [ys_buf, sa]
            grads = torch.autograd.grad(outs, inputs, grad_outputs=cts, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
        g_t, g_dt, g_dteff, g_qold, g_y, g_f0, g_t0, g_t1 = grads[:8]
        # ONE sweep backward: the history holds every primal
        s_t, s_dteff, s_y, s_f0, s_leaves = eng.sweep_bwd(
            t, dt_eff, y, f0c, tuple(leaves), tuple(g.contiguous() for g in grads[8:13]))
        tot = g_dteff + s_dteff.to(zrow.dtype)
        ct_t = g_t + s_t.to(zrow.dtype) - torch.where(is_last, tot, zrow)
        ct_dt = g_dt + torch.where(is_last, zrow, tot)
        ct_t1x = ct_t1x + g_t1 + torch.where(is_last, tot, zrow)
        ct_t0x = ct_t0x + g_t0
        ct_qold = g_qold
        ct_y = g_y + s_y
        ct_f0 = g_f0 + s_f0
        ct_leaves = [a + b for a, b in zip(ct_leaves, s_leaves)]
        if has_saveat:
            ct_ys = grads[13]
            ct_sa = ct_sa + grads[14]
    return (ct_t + ct_t0x, ct_t1x, ct_dt, ct_y, ct_f0,
            ct_ys if has_saveat else torch.zeros_like(ys_init), ct_sa, *ct_leaves)


def odeint_per_sample_batched(
    func: Callable,
    y0: torch.Tensor,
    t0,
    t1,
    args=(),
    *,
    solver: str = "tsit5",
    rtol: float = 1e-6,
    atol: float = 1e-6,
    max_steps: int = 256,
    mode: str = "adjoint",
    saveat=None,
    controller: Optional[PIController] = None,
    stage_sweep_lanes: Optional[Callable] = None,
    stage_sweep_lanes_bwd: Optional[Callable] = None,
) -> ODESolution:
    """Integrate every row of ``y0`` (``(batch, dim)``) under its own
    adaptive controller (see the module docstring).

    ``t0``, ``t1``: scalars or ``(batch,)`` vectors. ``args`` is a tuple of
    tensors (the dynamics' leaves); gradients reach them, ``y0``, ``t0``,
    ``t1`` and ``saveat``. ``stage_sweep_lanes(t, dt, y, k1, args)`` returns
    ``(y_new, k_last, err, k_prev, g_prev)`` and ``stage_sweep_lanes_bwd(t,
    dt, y, k1, args, cts)`` its reverse ``(ct_t, ct_dt, ct_y, ct_k1,
    ct_args)``; without them the traced sweep over ``func`` and its autograd
    reverse run.

    Returns an ``ODESolution`` whose ``stats`` fields are ``(batch,)``
    tensors (``nfe = 2 + 6 * (naccept + nreject)`` per lane) and whose
    telemetry streams are ``(batch, max_steps)``; with ``saveat``, ``ys`` is
    ``(n_save, batch, dim)`` and ``ts`` the grid as given.
    """
    if mode == "scan":
        raise NotImplementedError(
            "mode='scan' (the bounded, twice-differentiable scan) is not ported yet "
            "(ROADMAP.md queue 1 item 3); use 'adjoint'")
    if mode not in ("adjoint", "while"):
        raise ValueError(
            f"mode must be 'adjoint' or 'while' for the batched per-sample engine, got {mode!r}")
    if solver != "tsit5":
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet; the port has Tsit5 only")
    if (stage_sweep_lanes is None) != (stage_sweep_lanes_bwd is None):
        raise ValueError("stage_sweep_lanes and stage_sweep_lanes_bwd go together")
    if y0.dim() != 2:
        raise ValueError(
            f"the batched per-sample engine needs a 2-D (batch, dim) state, got shape "
            f"{tuple(y0.shape)}")
    with _highest_matmul_precision():
        return _run(func, y0, t0, t1, tuple(args), rtol, atol, max_steps, mode, saveat,
                    controller, stage_sweep_lanes, stage_sweep_lanes_bwd)


def _run(func, y0, t0, t1, args, rtol, atol, max_steps, mode, saveat, controller, sweep,
         sweep_bwd):
    if sweep is None:
        sweep = lambda t, dt, y, f0, a: traced_sweep_lanes(func, t, dt, y, f0, a)
        sweep_bwd = lambda t, dt, y, f0, a, cts: traced_sweep_lanes_bwd(
            func, t, dt, y, f0, a, cts)
    ctrl = controller or PIController.for_order(TSIT5.order)
    batch, dim = y0.shape
    tdt = torch.promote_types(y0.dtype, torch.float32)
    t0v = torch.as_tensor(t0, dtype=tdt, device=y0.device).expand(batch)
    t1v = torch.as_tensor(t1, dtype=tdt, device=y0.device).expand(batch)
    tdir = torch.sign(t1v - t0v)

    ts = None
    if saveat is not None:
        ts = torch.as_tensor(saveat, dtype=tdt, device=y0.device)
        if ts.dim() not in (1, 2) or (ts.dim() == 2 and ts.shape[0] != batch):
            raise ValueError(
                f"saveat must be (n_save,) or ({batch}, n_save); got shape {tuple(ts.shape)}")
        saveat = ts.expand(batch, ts.shape[-1]) if ts.dim() == 1 else ts
        # stamps at or before each lane's t0 hold its initial state
        at_start = (saveat - t0v[:, None]) * tdir[:, None] <= 0
        ys_init = torch.where(at_start[:, :, None], y0[:, None, :],
                              y0.new_zeros((batch, saveat.shape[1], dim)))
    else:
        ys_init = y0.new_zeros((batch, 0, dim))

    f0 = func(t0v, y0, args)
    dt_init, _ = _per_lane_initial_dt(func, t0v, y0, f0, args, TSIT5.order, rtol, atol, t1v)
    eng = _Engine(sweep, sweep_bwd, ctrl, float(rtol), float(atol), max_steps)

    if mode == "while":
        with torch.no_grad():
            (y1, ys, done, na, nr), rows, _ = _solve_forward(
                eng, t0v, t1v, dt_init, y0, f0, ys_init if saveat is not None else None,
                saveat, args, keep=False)
        tel = _telemetry(rows, max_steps)
    else:
        (y1, ys, tt, tdt_, te, tg, acc, live, na, nr, done) = PerSampleAdjointSolve.apply(
            eng, t0v, t1v, dt_init, y0, f0, ys_init, saveat, *args)
        tel = StepTelemetry(tt, tdt_, te, tg, acc, live)
    stats = ODEStats(nfe=2 + (TSIT5.num_stages - 1) * (na + nr), naccept=na, nreject=nr,
                     success=done)
    if saveat is None:
        return ODESolution(y1=y1, stats=stats, telemetry=tel)
    return ODESolution(y1=y1, stats=stats, telemetry=tel, ys=ys.transpose(0, 1), ts=ts)
