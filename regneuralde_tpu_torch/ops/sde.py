"""Adaptive SDE integration (diagonal noise) with telemetry and an adjoint.

Counterpart of ``regneuralde_tpu/ops/sde.py``, restricted to what the MNIST
Neural-SDE training step runs: the tableau-driven SRI methods of
``ops.sri`` (``solver="sosri" | "sosri2" | "sriw1"``) with the
natural-embedding error estimate driving ``PIController(beta1=0.5,
beta2=0)``, the collapse Brownian bridge (``brownian="collapse"``), the
adjoint solve (``mode="adjoint"``) and a forward-only ``"while"`` mode, and
linear interpolation at ``saveat`` stamps on each accepted step.

**The draws.** PyTorch cannot reproduce JAX's threefry key chain, so the
N(0, 1) draws are explicit: ``noise=(xi_w, xi_z)``, each ``(max_steps,) +
y0.shape``, row ``i`` consumed by trial step ``i`` (accepted or not), or a
``torch.Generator`` from which ``presample_noise`` draws them once. These
are exactly the draws JAX's ``sdeint`` makes from ``key`` when the buffers
hold ``regneuralde_tpu.ops.pallas_sde.presample_noise(key, ...)``, and the
buffers the whole-solve kernels read (``ops.sde_whole_solve``), so every
route takes the same Brownian path.

**The bridge.** On a rejection the increment over the attempted interval
is committed as a tail ``(h, w, z)`` and the retry samples a Brownian-bridge
point inside it; on an acceptance inside the tail the remainder is carried
forward (JAX's ``_sample_increment``, its zero-guarded ``std`` included).

**The adjoint.** The forward loop runs on the host, one host sync a trial
step (the accept flag), and stores each trial step's start ``(t, dt, qold,
tail_h)`` and rows ``(y, tail_w, tail_z)``. The backward replays each live
step in reverse with ``torch.autograd`` (JAX's ``_sde_adjoint_solve``),
threading the cotangents of ``t, dt, qold, y``, the tail, the ``saveat``
rows, ``t1``, ``span`` and the leaves. The draws get no cotangent.

Not ported (``NotImplementedError`` naming ``ROADMAP.md``): ``mode="scan"``,
``solver="em"`` and ``brownian="stack"``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from regneuralde_tpu_torch.ops.controller import PIController
from regneuralde_tpu_torch.ops.norms import scaled_error
from regneuralde_tpu_torch.ops.ode import StepTelemetry, _telemetry
from regneuralde_tpu_torch.ops.sri import (
    TABLEAUS,
    diffusion_evals_per_step,
    drift_evals_per_step,
    get_tableau,
    sri_step,
)

_TINY = 1e-30


class SDEStats(NamedTuple):
    nfe1: int  # drift evaluations
    nfe2: int  # diffusion evaluations
    naccept: int
    nreject: int
    success: bool  # reached t1 within max_steps


class SDESolution(NamedTuple):
    y1: torch.Tensor
    ys: Optional[torch.Tensor]  # states at ``ts``, (len(ts),) + y1.shape
    ts: Optional[torch.Tensor]
    stats: SDEStats
    telemetry: StepTelemetry


class Tail(NamedTuple):
    h: torch.Tensor  # committed horizon ahead of t (0: no tail)
    w: torch.Tensor  # Brownian increment over [t, t + h]
    z: torch.Tensor  # auxiliary increment (the I10 integral) over [t, t + h]


def presample_noise(generator: torch.Generator, shape, max_steps: int, *,
                    dtype=torch.float32, device=None):
    """``(xi_w, xi_z)``: N(0, 1) draws of shape ``(max_steps,) + shape``,
    drawn once from ``generator`` (on its device unless ``device`` says
    otherwise), one pair of rows per trial step."""
    device = generator.device if device is None else device
    full = (max_steps,) + tuple(shape)
    xi_w = torch.randn(full, generator=generator, dtype=dtype, device=device)
    xi_z = torch.randn(full, generator=generator, dtype=dtype, device=device)
    return xi_w, xi_z


class Bridge(NamedTuple):
    """The collapse bridge's scalars of a trial step from ``dt`` and the
    tail's horizon ``h``: ``dW = frac * tail_w + std * xi_w``."""

    inside: torch.Tensor  # the step ends inside the committed tail
    safe_h: torch.Tensor
    frac: torch.Tensor
    var0: torch.Tensor  # the bridge's variance before the clamp at 0
    var: torch.Tensor
    std: torch.Tensor


def bridge_scalars(dt, h) -> Bridge:
    zero, one = torch.zeros_like(h), torch.ones_like(h)
    safe_h = torch.maximum(h, one * _TINY)
    inside = dt < h
    frac = torch.where(inside, dt / safe_h, one)
    var0 = torch.where(inside, dt * (h - dt) / safe_h, torch.maximum(dt - h, zero))
    # Zero-guarded sqrt (sqrt'(0) = inf poisons the backward): var is exactly
    # 0 when a step consumes the committed tail exactly.
    var = torch.maximum(var0, zero)
    pos = var > 0
    std = torch.where(pos, torch.sqrt(torch.where(pos, var, one)), zero)
    return Bridge(inside, safe_h, frac, var0, var, std)


def _sample_increment(tail: Tail, dt, xi_w, xi_z):
    """``(dW, dZ)`` over ``[t, t + dt]`` conditioned on the committed tail,
    from the draws ``xi_w, xi_z``; returns ``(dW, dZ, tail_if_accepted,
    tail_if_rejected)``."""
    br = bridge_scalars(dt, tail.h)
    dw = br.frac * tail.w + br.std * xi_w
    dz = br.frac * tail.z + br.std * xi_z
    rem_w = torch.where(br.inside, tail.w - dw, torch.zeros_like(dw))
    rem_z = torch.where(br.inside, tail.z - dz, torch.zeros_like(dz))
    tail_acc = Tail(torch.where(br.inside, tail.h - dt, torch.zeros_like(tail.h)), rem_w, rem_z)
    tail_rej = Tail(dt, dw, dz)
    return dw, dz, tail_acc, tail_rej


def save_rows_at_start(saveat, t0, y0):
    """``saveat`` as a tensor of ``t0``'s type and the rows' initial values:
    ``y0`` at stamps at or before ``t0``, zero elsewhere."""
    saveat = torch.as_tensor(saveat, dtype=t0.dtype, device=y0.device)
    at_start = (saveat - t0 <= 0).reshape((-1,) + (1,) * y0.dim())
    return saveat, torch.where(at_start, y0.unsqueeze(0),
                               y0.new_zeros((saveat.shape[0],) + tuple(y0.shape)))


class StepOut(NamedTuple):
    t: torch.Tensor
    dt: torch.Tensor
    qold: torch.Tensor
    y: torch.Tensor
    tail: Tail
    ys: Optional[torch.Tensor]
    tel_t: torch.Tensor
    dt_eff: torch.Tensor
    eest: torch.Tensor
    eigen_est: torch.Tensor
    accept: torch.Tensor
    is_last: torch.Tensor
    sums: tuple  # (err_ssq, num_ssq, den_ssq)


def sde_terms(tab, drift, diffusion, args, t, y, dt_eff, tail, xi_w, xi_z, rtol, atol):
    """The row work of one trial step: the bridge, the SRI stages and the
    three sums of squares behind the error estimate and the stiffness
    proxy. Returns ``(y_new, tail_if_accepted, tail_if_rejected, (err_ssq,
    num_ssq, den_ssq))``."""
    dw, dz, tail_acc, tail_rej = _sample_increment(tail, dt_eff, xi_w, xi_z)
    y_new, err, (f_a, f_b, h_a, h_b) = sri_step(tab, drift, diffusion, args, t, y,
                                               dt_eff, dw, dz)
    scaled = scaled_error(err, y, y_new, rtol, atol)
    sums = tuple(torch.sum(torch.square(x)) for x in (scaled, f_b - f_a, h_b - h_a))
    return y_new, tail_acc, tail_rej, sums


def sde_post(ctrl: PIController, count, t, dt_eff, qold, e, n, d, t1, span, is_last):
    """The scalar chain of one trial step after its sums: ``(t_new, dt_next,
    qold_next, t_end, eest, eigen_est)``. ``eest = hairer_norm(scaled
    error)`` and ``eigen_est = hairer_norm(f_b - f_a) / hairer_norm(H0_b -
    H0_a)``, each norm zero-guarded; the controller's step is clamped to
    ``span`` (forward time only)."""
    one, zero = torch.ones_like(e), torch.zeros_like(e)
    rms = lambda s: torch.where(s > 0, torch.sqrt(torch.where(s > 0, s, one) / count), zero)
    eest, num, den = rms(e), rms(n), rms(d)
    eigen = torch.where(den > 0, num / torch.maximum(den, one * _TINY), zero)
    accept = eest <= 1.0
    dt_next, qold_next = ctrl.propose(dt_eff, eest, qold, accept)
    dt_next = torch.minimum(dt_next, span).to(dt_eff.dtype)
    t_end = torch.where(is_last, t1, t + dt_eff)
    t_new = torch.where(accept, t_end, t)
    return t_new, dt_next, qold_next.to(qold.dtype), t_end, eest, eigen


def make_step(tab, drift, diffusion, ctrl: PIController, rtol, atol, eest_dtype):
    """One SRI trial step as a pure function of the carry (JAX's
    ``make_step``): ``step(t, dt, qold, y, tail, ys, t1, span, saveat, args,
    xi_w, xi_z) -> StepOut``, every output selected by the accept flag with
    ``torch.where``, so that autograd of the replay is the step's pullback."""

    def step(t, dt, qold, y, tail, ys, t1, span, saveat, args, xi_w, xi_z):
        remaining = t1 - t
        is_last = dt >= remaining
        dt_eff = torch.where(is_last, remaining, dt)
        y_new, tail_acc, tail_rej, sums = sde_terms(tab, drift, diffusion, args, t, y, dt_eff,
                                                    tail, xi_w, xi_z, rtol, atol)
        e, n, d = (x.to(eest_dtype) for x in sums)
        t_new, dt_next, qold_next, t_end, eest, eigen = sde_post(
            ctrl, float(y.numel()), t, dt_eff, qold, e, n, d, t1, span, is_last)
        accept = eest <= 1.0
        y_out = torch.where(accept, y_new, y)
        tail_out = Tail(*(torch.where(accept, a, r) for a, r in zip(tail_acc, tail_rej)))
        ys_out = ys
        if saveat is not None:
            win = accept & (saveat - t > 0) & (saveat - t_end <= 0)
            theta = (saveat - t) / torch.where(dt_eff == 0, torch.ones_like(dt_eff), dt_eff)
            th = theta.to(y.dtype).reshape((-1,) + (1,) * y.dim())
            yi = (1 - th) * y + th * y_new
            ys_out = torch.where(win.reshape((-1,) + (1,) * y.dim()), yi, ys)
        return StepOut(t_new, dt_next, qold_next, y_out, tail_out, ys_out, t_end, dt_eff,
                       eest, eigen, accept, is_last, (e, n, d))

    return step


def _forward_loop(step, max_steps, t0, t1, dt_init, qold0, y0, ys_init, saveat, args,
                  xi_w, xi_z, keep_history):
    """The trial-step loop: one host sync a trial step (accept and is_last).
    Returns ``(final StepOut-like carry, telemetry rows, accepted, done,
    history)``."""
    span = t1 - t0
    tail = Tail(torch.zeros_like(t0), torch.zeros_like(y0), torch.zeros_like(y0))
    t, dt, qold, y, ys = t0, dt_init, qold0, y0, ys_init
    rows, accepted, hist = [], [], []
    done = bool(span == 0)
    while not done and len(accepted) < max_steps:
        i = len(accepted)
        if keep_history:
            hist.append((t, dt, qold, y, tail.h, tail.w, tail.z))
        out = step(t, dt, qold, y, tail, ys, t1, span, saveat, args, xi_w[i], xi_z[i])
        rows.append((out.tel_t, out.dt_eff, out.eest, out.eigen_est))
        acc_flag, last_flag = torch.stack((out.accept, out.is_last)).tolist()
        accepted.append(acc_flag)
        t, dt, qold, y, tail, ys = out.t, out.dt, out.qold, out.y, out.tail, out.ys
        done = acc_flag and last_flag
    return (t, dt, qold, y, ys), rows, accepted, done, hist


class SDEAdjointSolve(torch.autograd.Function):
    """The adjoint SDE solve (``_sde_adjoint_solve``). Inputs ``t0, t1,
    dt_init, y0``, the ``saveat`` rows' initial values ``ys_init`` (empty
    without ``saveat``) and the leaves; outputs ``y1``, the rows ``ys``, the
    telemetry streams ``t, dt, eest, eigen_est`` and, not differentiable,
    the accept and live masks and ``(naccept, nreject, done)``."""

    @staticmethod
    def forward(ctx, step, max_steps, saveat, xi_w, xi_z, qold0, t0, t1, dt_init, y0,
                ys_init, *leaves):
        ys0 = ys_init if saveat is not None else None
        (t, dt, qold, y1, ys), rows, accepted, done, hist = _forward_loop(
            step, max_steps, t0, t1, dt_init, qold0, y0, ys0, saveat, leaves, xi_w, xi_z,
            keep_history=True)
        tel = _telemetry(rows, accepted, max_steps, t0)
        counts = torch.tensor([sum(accepted), len(accepted) - sum(accepted), int(done)])
        ys = ys_init.clone() if ys is None or ys is ys_init else ys
        ctx.mark_non_differentiable(tel.accepted, tel.live, counts)
        ctx.step, ctx.max_steps, ctx.saveat, ctx.hist = step, max_steps, saveat, hist
        ctx.save_for_backward(t0, t1, y0, ys_init, xi_w, xi_z, *leaves)
        return (y1, ys, tel.t, tel.dt, tel.eest, tel.eigen_est, tel.accepted, tel.live,
                counts)

    @staticmethod
    def backward(ctx, ct_y1, ct_ys, ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g, *_):
        t0, t1, y0, ys_init, xi_w, xi_z, *leaves = ctx.saved_tensors
        saveat, step = ctx.saveat, ctx.step
        span = t1 - t0
        zero = torch.zeros_like(t0)
        S = ctx.max_steps
        ct_tel = [zero.new_zeros(S) if c is None else c
                  for c in (ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g)]
        ct_y = torch.zeros_like(y0) if ct_y1 is None else ct_y1
        ct_ys = torch.zeros_like(ys_init) if ct_ys is None else ct_ys
        ct_t, ct_dt = zero, zero
        ct_qold = None
        ct_th, ct_tw, ct_tz = zero, torch.zeros_like(y0), torch.zeros_like(y0)
        ct_leaves = [torch.zeros_like(x) for x in leaves]
        ct_t1x, ct_spanx = zero, zero
        ys_zero = torch.zeros_like(ys_init) if saveat is not None else None
        for i in range(len(ctx.hist) - 1, -1, -1):
            t_i, dt_i, qold_i, y_i, th_i, tw_i, tz_i = ctx.hist[i]
            if ct_qold is None:
                ct_qold = torch.zeros_like(qold_i)
            prim = [x.detach().requires_grad_(True)
                    for x in (t_i, dt_i, qold_i, y_i, th_i, tw_i, tz_i, t1, span, *leaves)]
            ys_in = None
            if saveat is not None:
                ys_in = ys_zero.detach().requires_grad_(True)
                prim.append(ys_in)
            with torch.enable_grad():
                out = step(*prim[:4], Tail(*prim[4:7]), ys_in, prim[7], prim[8], saveat,
                           tuple(prim[9:9 + len(leaves)]), xi_w[i], xi_z[i])
                outs = [out.t, out.dt, out.qold, out.y, *out.tail, out.tel_t, out.dt_eff,
                        out.eest, out.eigen_est]
                seeds = [ct_t, ct_dt, ct_qold, ct_y, ct_th, ct_tw, ct_tz, ct_tel[0][i],
                         ct_tel[1][i], ct_tel[2][i], ct_tel[3][i]]
                if saveat is not None:
                    outs.append(out.ys)
                    seeds.append(ct_ys)
                grads = torch.autograd.grad(outs, prim, grad_outputs=seeds,
                                            allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, prim)]
            ct_t, ct_dt, ct_qold, ct_y, ct_th, ct_tw, ct_tz, d_t1, d_span = grads[:9]
            ct_t1x = ct_t1x + d_t1
            ct_spanx = ct_spanx + d_span
            ct_leaves = [a + b for a, b in zip(ct_leaves, grads[9:9 + len(leaves)])]
            if saveat is not None:
                ct_ys = grads[-1]
        ctx.hist = None
        return (None,) * 6 + (ct_t - ct_spanx, ct_t1x + ct_spanx, ct_dt, ct_y, ct_ys,
                              *ct_leaves)


def _check_noise(noise, y0, max_steps):
    xi_w, xi_z = noise
    for name, x in (("xi_w", xi_w), ("xi_z", xi_z)):
        if (x.dim() != y0.dim() + 1 or x.shape[0] < max_steps
                or tuple(x.shape[1:]) != tuple(y0.shape) or x.device != y0.device):
            raise ValueError(f"noise {name} must be (max_steps,) + y0.shape = "
                             f"{(max_steps,) + tuple(y0.shape)} on {y0.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
    return xi_w.to(y0.dtype), xi_z.to(y0.dtype)


def resolve_noise(noise, generator, y0, max_steps):
    """The draws of a solve: ``noise`` checked, or drawn from
    ``generator``; exactly one of the two must be given."""
    if (noise is None) == (generator is None):
        raise ValueError("pass exactly one of noise=(xi_w, xi_z) or generator= "
                         "(the port has no global RNG)")
    if noise is None:
        noise = presample_noise(generator, y0.shape, max_steps, dtype=y0.dtype,
                                device=y0.device)
    return _check_noise(noise, y0, max_steps)


def check_options(solver, mode, brownian):
    """``sdeint``'s option checks: unknown values raise ``ValueError``, the
    JAX options not ported yet ``NotImplementedError``."""
    if brownian not in ("collapse", "stack"):
        raise ValueError(f"unknown brownian {brownian!r}; use 'collapse' or 'stack'")
    if brownian == "stack":
        raise NotImplementedError("brownian='stack' (the RSwM3 segment stack) is not "
                                  "ported yet (ROADMAP.md queue 1)")
    if solver != "em" and solver not in TABLEAUS:
        raise ValueError(f"unknown SDE solver {solver!r}; use 'em' or one of "
                         f"{sorted(TABLEAUS)}")
    if solver == "em":
        raise NotImplementedError("solver='em' (fixed-step Euler-Maruyama) is not "
                                  "ported yet (ROADMAP.md queue 1)")
    if mode == "scan":
        raise NotImplementedError("mode='scan' (the differentiable bounded scan) is not "
                                  "ported yet (ROADMAP.md queue 1); use 'adjoint'")
    if mode not in ("adjoint", "while"):
        raise ValueError(f"unknown mode {mode!r}; use 'adjoint', 'scan' or 'while'")


def sde_prologue(y0, t0, t1, dt0):
    """The time scalars as tensors of the time type (float32 at least)
    and the initial step ``min(0.01, span)`` (or ``dt0`` as given)."""
    time_dtype = torch.promote_types(y0.dtype, torch.float32)
    t0 = torch.as_tensor(t0, dtype=time_dtype, device=y0.device)
    t1 = torch.as_tensor(t1, dtype=time_dtype, device=y0.device)
    if dt0 is None:
        dt_init = torch.minimum(torch.full_like(t0, 0.01), t1 - t0)
    else:
        dt_init = torch.as_tensor(dt0, dtype=time_dtype, device=y0.device)
    return t0, t1, dt_init


def sde_stats(tab, naccept, nreject, done) -> SDEStats:
    n = naccept + nreject
    return SDEStats(nfe1=drift_evals_per_step(tab) * n,
                    nfe2=diffusion_evals_per_step(tab) * n,
                    naccept=naccept, nreject=nreject, success=bool(done))


def sdeint(
    drift: Callable,
    diffusion: Callable,
    y0: torch.Tensor,
    t0,
    t1,
    args=(),
    *,
    noise=None,
    generator: Optional[torch.Generator] = None,
    solver: str = "sosri",
    rtol: float = 1e-2,
    atol: float = 1e-2,
    dt0: Optional[float] = None,
    max_steps: int = 256,
    saveat=None,
    controller: Optional[PIController] = None,
    mode: str = "adjoint",
    brownian: str = "collapse",
) -> SDESolution:
    """Integrate ``dy = drift(t, y, args) dt + diffusion(t, y, args) dW``
    (diagonal noise) from ``t0`` to ``t1 > t0``.

    ``args`` is a tuple of tensors (the dynamics' leaves); gradients reach
    them, ``y0``, ``t0`` and ``t1``. The draws are ``noise=(xi_w, xi_z)``
    or come from ``generator`` (``presample_noise``); exactly one is
    given. The minibatch is one SDE state with one global error norm, as
    in the JAX package. ``saveat``: 1-D sorted stamps; ``ys`` holds the
    state at each (linear interpolation on the accepted step that covers
    it; stamps at or before ``t0`` hold ``y0``)."""
    check_options(solver, mode, brownian)
    tab = get_tableau(solver)
    ctrl = controller or PIController(beta1=0.5, beta2=0.0)
    args = tuple(args)
    t0, t1, dt_init = sde_prologue(y0, t0, t1, dt0)
    xi_w, xi_z = resolve_noise(noise, generator, y0, max_steps)
    eest_dtype = torch.promote_types(y0.dtype, torch.float32)
    # qold is float32 whatever the state's type, as in the JAX package
    qold0 = torch.full((), ctrl.qoldinit, dtype=torch.float32, device=y0.device)
    step = make_step(tab, drift, diffusion, ctrl, rtol, atol, eest_dtype)
    if saveat is not None:
        saveat, ys_init = save_rows_at_start(saveat, t0, y0)
    else:
        ys_init = y0.new_zeros((0,) + tuple(y0.shape))

    if mode == "while":
        with torch.no_grad():
            (_, _, _, y1, ys), rows, accepted, done, _ = _forward_loop(
                step, max_steps, t0, t1, dt_init, qold0, y0,
                ys_init if saveat is not None else None, saveat, args, xi_w, xi_z,
                keep_history=False)
        tel = _telemetry(rows, accepted, max_steps, t0)
        naccept, nreject = sum(accepted), len(accepted) - sum(accepted)
    else:
        (y1, ys, tel_t, tel_dt, tel_e, tel_g, acc, live, counts) = SDEAdjointSolve.apply(
            step, max_steps, saveat, xi_w, xi_z, qold0, t0, t1, dt_init, y0, ys_init, *args)
        tel = StepTelemetry(tel_t, tel_dt, tel_e, tel_g, acc, live)
        naccept, nreject, done = counts.tolist()
    return SDESolution(y1=y1, ys=ys if saveat is not None else None, ts=saveat,
                       stats=sde_stats(tab, naccept, nreject, done), telemetry=tel)
