"""The whole adaptive SRI solve: one kernel per direction (K9/K10).

Counterpart of ``regneuralde_tpu/ops/pallas_sde.py``: ``whole_solve_sdeint``
runs the whole adaptive SDE solve of a drift/diffusion pair in one forward
launch (K9, ``sde_whole_solve_fwd_kernel`` in ``csrc/sde_whole_solve.cu``)
and one backward launch (K10, the reverse walk of K9's history). Two pairs,
chosen by ``body``:

- ``"mlp"``: an MLP drift and an MLP diffusion (``models.MLP``, tanh between
  layers, linear out, no time input; the MNIST Neural SDE's pair),
  ``csrc/sri_mlp.cuh``'s ``MlpPair``;
- ``"cubic"``: the drift's MLP applied to ``x * x * x`` (``models.
  CubicDrift``, the toy 2-D SDE's ``x -> x^3 -> 50 tanh -> 2``) and an MLP
  diffusion, ``csrc/sri_cubic.cuh``'s ``CubicPair``.

Both pairs run one forward tile body (K9's, and K10's recompute) and one
reverse tile body (K10's) on tiles of ``SDE_ROWS`` rows: each layer one
phase, a stage's drift and diffusion layers side by side, each f64 sum split
over lanes (``sde_lanes``); each pair's own widths (``FIXED_WIDTHS``: the
MNIST NSDE's and the toy's) are a compile-time instance, every other pair
the generic one. ``sde_tile_plan``
mirrors the kernels' sizes (``check_sde_plan`` holds it to the library's);
the wrappers size their launches from it. ``plain_sde_bwd_tiles`` is K10's
order of sums in plain PyTorch (tests only: on the card K10's outputs are
its bitwise).

The forward's record (``SDERecord``) is what the backward reads: per trial
step its start ``t, dt, qold, tail_h``, the three sums of squares (scaled
error, ``f_b - f_a``, ``H0_b - H0_a``), the accept flag and the telemetry;
the rows ``y, tail_w, tail_z`` at the start of each trial step; the
``saveat`` rows and the save cursors. The backward takes the stored accept
flags and sums, pulls the scalar chain back by hand (``sde_post_bwd``) and
recomputes each step's stages from its rows and draws for the row pullback
(``_sde_rows_bwd``); the draws get no cotangent.

Each kernel has a plain version with the same algebra and the same output
buffers: ``plain_sde_whole_solve_fwd`` (``ops.sde``'s trial step over the
pair, the affine maps summed in float64 and rounded once, as the kernels
do) and ``plain_sde_whole_solve_bwd`` (its reverse walk through
``_sde_step_bwd_math``, the hand pullback of one trial step). The wrappers
take the plain versions for CPU tensors, launch the kernels for CUDA
tensors and raise otherwise. ``saveat`` must be sorted: the kernels consume
it with a cursor (``pallas_sde.py``'s). No batch padding: the kernels mask
a ragged row tile.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from regneuralde_tpu_torch.ops import sde as sde_ops
from regneuralde_tpu_torch.ops.fused_generic import _leaf_pointers
from regneuralde_tpu_torch.ops.fused_mlp import _scalar_f32
from regneuralde_tpu_torch.ops.controller import _EEST_FLOOR, PIController
from regneuralde_tpu_torch.ops.ode import StepTelemetry, _max_grad, _min_grad
from regneuralde_tpu_torch.ops.sri import SRITableau, analyze, eigen_stages, get_tableau
from regneuralde_tpu_torch.ops.whole_solve import _check_tensor, _ctrl_args, _rows_through
from regneuralde_tpu_torch.ops.whole_solve import _opt_ptr as _ptr

# launches of K9 and K10 by tile body: the MLP pair's, then the cubic pair's
LAUNCHES = {"sde_whole_solve_fwd": 0, "sde_whole_solve_bwd": 0,
            "sde_whole_solve_cubic_fwd": 0, "sde_whole_solve_cubic_bwd": 0}

MAX_LAYERS = 4  # per network of the pair (the kernels' limit)
BODIES = ("mlp", "cubic")  # the kernels' tile bodies


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Rows of ``SDERecord.streams``.
(ST_T, ST_DT, ST_QOLD, ST_H, ST_E, ST_N, ST_D, ST_ACC,
 TEL_T, TEL_DT, TEL_EEST, TEL_EIGEN) = range(12)
N_STREAMS = 12


class SDERecord(NamedTuple):
    """What the forward solve writes (``S = max_steps``, ``ns`` trial steps).

    ``hy[i], hw[i], hz[i]`` hold the state and the Brownian tail's rows at
    the start of trial step ``i`` for ``i <= ns`` (row ``ns`` is the end of
    the solve); later rows are undefined. ``streams`` is ``(12, S)``: per
    trial step its start ``t, dt, qold, tail_h``, the sums ``err_ssq,
    num_ssq, den_ssq``, the accept flag (1.0 or 0.0) and the telemetry
    ``t_end, dt_eff, eest, eigen_est``; zero past step ``ns``. ``final`` is
    ``(t, dt, qold, naccept, nreject, done)``. ``ys`` holds the ``saveat``
    rows (empty without) and ``cursors`` (int32) ``(cur0, curf)``: rows
    ``[0, cur0)`` lie at or before ``t0``, rows ``[cur0, curf)`` were
    written."""

    y1: torch.Tensor
    hy: torch.Tensor
    hw: torch.Tensor
    hz: torch.Tensor
    streams: torch.Tensor
    final: torch.Tensor
    ys: torch.Tensor
    cursors: torch.Tensor


# ---------------------------------------------------------------------------
# The pairs: MLP drift (or MLP on the cube of the state) and MLP diffusion.
# ---------------------------------------------------------------------------


def _affine(x, W, b):
    """``x W^T + b`` summed in float64 and rounded once to ``x``'s type (the
    kernels' sums)."""
    return torch.addmm(b.double(), x.double(), W.double().t()).to(x.dtype)


def mlp_apply(x, layers):
    """An MLP over ``layers = [(W, b), ...]`` (``nn.Linear`` layout): tanh
    between layers, the last one linear."""
    return _mlp_fwd(x, layers)[-1]


def split_pair(leaves, n_drift):
    """The drift's and the diffusion's layers from the flat leaves (the
    drift's ``parameters()``, then the diffusion's)."""
    pairs = [(leaves[2 * l], leaves[2 * l + 1]) for l in range(len(leaves) // 2)]
    return pairs[:n_drift], pairs[n_drift:]


def _cube(x):
    """``x * x * x``: two products, as XLA's ``integer_pow`` computes ``x**3``."""
    return x * x * x


def _check_body(body):
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")


def pair_functions(n_drift, body="mlp"):
    """``(drift, diffusion)`` callables ``f(t, y, leaves)`` over the flat
    leaves; with ``body="cubic"`` the drift's MLP takes ``y * y * y``."""
    _check_body(body)
    pre = _cube if body == "cubic" else (lambda y: y)
    return (lambda t, y, lv: mlp_apply(pre(y), split_pair(lv, n_drift)[0]),
            lambda t, y, lv: mlp_apply(y, split_pair(lv, n_drift)[1]))


# ---------------------------------------------------------------------------
# One trial step and its hand pullback.
# ---------------------------------------------------------------------------


def plain_sde_trial_step(tab, ctrl, rtol, atol, t, dt, qold, tail_h, y, tail_w, tail_z,
                         xi_w, xi_z, t1, span, leaves, n_drift, body="mlp") -> sde_ops.StepOut:
    """One SRI trial step over the pair (``ops.sde.make_step``, without
    ``saveat``): the trial step of JAX's ``pallas_sde.trial_step`` on
    tensors. The controller's step is clamped as ``min(dt_next, span)``."""
    drift, diffusion = pair_functions(n_drift, body)
    step = sde_ops.make_step(tab, drift, diffusion, ctrl, rtol, atol,
                             torch.promote_types(y.dtype, torch.float32))
    return step(t, dt, qold, y, sde_ops.Tail(tail_h, tail_w, tail_z), None, t1, span, None,
                tuple(leaves), xi_w, xi_z)


def sde_post_bwd(ctrl, count, t, dt_eff, qold, e, n, d, t1, span, is_last, accept, cts):
    """Hand pullback of ``ops.sde.sde_post``: ``cts`` are the cotangents of
    ``(t_new, dt_next, qold_next, t_end, eest, eigen_est)``; returns those
    of ``(t, dt_eff, qold, e, n, d, t1, span)``. Autograd's tie rules;
    ``accept`` is the stored flag. ``csrc/sde_whole_solve.cu`` runs the same
    algebra."""
    c_tnew, c_dtn, c_qn, c_tend, c_eest, c_eig = cts
    zero, one = torch.zeros_like(e), torch.ones_like(e)
    pe, pn, pd = e > 0, n > 0, d > 0
    rms = lambda s, p: torch.where(p, torch.sqrt(torch.where(p, s, one) / count), zero)
    eest, num, den = rms(e, pe), rms(n, pn), rms(d, pd)
    tiny = one * 1e-30
    mden = torch.maximum(den, tiny)
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
        in_band = torch.zeros_like(pe)
        qa = qa0
    r = q11 / ctrl.gamma
    q_rej = torch.minimum(hi, r)
    dt0 = torch.where(accept, dt_eff / qa, dt_eff / q_rej)

    # t_new = where(accept, t_end, t); t_end = where(is_last, t1, t + dt_eff)
    g_tend = c_tend + torch.where(accept, c_tnew, zero)
    g_t = torch.where(accept, zero, c_tnew)
    g_t1 = torch.where(is_last, g_tend, zero)
    g_lin = torch.where(is_last, zero, g_tend)
    g_t = g_t + g_lin
    g_dteff = g_lin
    # dt_next = minimum(dt0, span)
    g_dt0 = _min_grad(dt0, span, c_dtn)
    g_span = _min_grad(span, dt0, c_dtn)
    # qold_next = where(accept, maximum(eest, qoldinit), qold)
    g_qold = torch.where(accept, zero, c_qn)
    g_eest = c_eest + _max_grad(eest, one * ctrl.qoldinit, torch.where(accept, c_qn, zero))
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
    # eigen = where(den > 0, num / maximum(den, 1e-30), 0)
    g_ratio = torch.where(den > 0, c_eig, zero)
    g_num = g_ratio / mden
    g_den = _max_grad(den, tiny, -g_ratio * ((num / mden) / mden))
    g_e = torch.where(pe, (g_eest / (2 * eest)) / count, zero)
    g_n = torch.where(pn, (g_num / (2 * num)) / count, zero)
    g_d = torch.where(pd, (g_den / (2 * den)) / count, zero)
    return g_t, g_dteff, g_qold, g_e, g_n, g_d, g_t1, g_span


def bridge_scalars_bwd(dt_eff, h, br: sde_ops.Bridge, g_frac, g_std):
    """Pullback of ``ops.sde.bridge_scalars`` to ``(dt_eff, h)`` for the cotangents
    of ``frac`` and ``std``."""
    zero = torch.zeros_like(h)
    inside = br.inside
    g_dteff = torch.where(inside, g_frac / br.safe_h, zero)
    g_safe = torch.where(inside, -g_frac * ((dt_eff / br.safe_h) / br.safe_h), zero)
    pos = br.var > 0
    g_var = torch.where(pos, g_std / (2 * br.std), zero)
    g_var0 = _max_grad(br.var0, zero, g_var)
    # inside: var0 = dt_eff * (h - dt_eff) / safe_h
    g_p = torch.where(inside, g_var0 / br.safe_h, zero)
    p = dt_eff * (h - dt_eff)
    g_safe = g_safe - torch.where(inside, g_var0 * ((p / br.safe_h) / br.safe_h), zero)
    g_dteff = g_dteff + g_p * (h - dt_eff) - g_p * dt_eff
    g_h = g_p * dt_eff
    # outside: var0 = maximum(dt_eff - h, 0)
    g_m = _max_grad(dt_eff - h, zero, torch.where(inside, zero, g_var0))
    g_dteff = g_dteff + g_m
    g_h = g_h - g_m + _max_grad(h, torch.ones_like(h) * 1e-30, g_safe)
    return g_dteff, g_h


def _mlp_fwd(x, layers):
    """The activations ``[x, h_1, ..., out]`` of ``mlp_apply``."""
    acts = [x]
    for l, (W, b) in enumerate(layers):
        h = _affine(acts[-1], W, b)
        acts.append(torch.tanh(h) if l < len(layers) - 1 else h)
    return acts


def _mlp_bwd(acts, layers, c_out, c_layers):
    """Pullback of ``mlp_apply`` from its activations: adds the layers'
    cotangents to ``c_layers`` and returns the input's."""
    g = c_out
    for l in range(len(layers) - 1, -1, -1):
        W = layers[l][0]
        if l < len(layers) - 1:
            h = acts[l + 1]
            g = g * (1 - h * h)
        c_layers[l][0].add_(g.t() @ acts[l])
        c_layers[l][1].add_(g.sum(0))
        g = g @ W
    return g


def _drift_fwd(x, layers, body):
    """The drift's activations (``_mlp_fwd``'s), the cubic body's MLP on
    ``x * x * x``."""
    return _mlp_fwd(_cube(x) if body == "cubic" else x, layers)


def _drift_bwd(x, acts, layers, c_out, c_layers, body):
    """Pullback of ``_drift_fwd``: the cubic body's input cotangent is
    ``g * (3 * (x * x))``, JAX's ``integer_pow`` rule."""
    g = _mlp_bwd(acts, layers, c_out, c_layers)
    return g * (3.0 * (x * x)) if body == "cubic" else g


def _sde_rows_bwd(tab, rtol, atol, dt_eff, br: sde_ops.Bridge, accept, y, tw, tz, xw, xz, layers_f,
                  layers_g, g_e, g_n, g_d, c_yout, c_two, c_tzo, c_y_save=None,
                  c_ynew_save=None, body="mlp"):
    """The row part of one trial step's pullback (K10's tile body):
    recomputes the bridge's increments, the Itô coefficients and the SRI
    stages, and pulls back the outputs ``y_out, tail_w_out, tail_z_out``
    and the three sums (cotangents ``g_e, g_n, g_d``), plus the ``saveat``
    rows' cotangents of ``y`` and ``y_new``. Returns ``(ct_y, ct_tw, ct_tz,
    c_layers_f, c_layers_g, (p_dteff, p_sqdt, p_frac, p_std))``: the
    partials are the cotangents of ``dt_eff`` (its direct uses), of
    ``sqrt(dt_eff)`` and of the bridge's ``frac`` and ``std``."""
    an = analyze(tab)
    s = tab.stages
    inside = br.inside
    zeros = torch.zeros_like(y)
    # ---- forward recompute ----
    dw = br.frac * tw + br.std * xw
    dz = br.frac * tz + br.std * xz
    sqdt = torch.sqrt(dt_eff)
    i11 = 0.5 * (dw * dw - dt_eff) / sqdt
    i10 = 0.5 * (dw + dz / math.sqrt(3.0))
    i111 = (dw * dw * dw - 3.0 * dt_eff * dw) / (6.0 * dt_eff)
    fs, gs, h0s, acts_f, acts_g = [None] * s, [None] * s, [None] * s, [None] * s, [None] * s
    for i in range(s):
        if an.f_used[i]:
            if an.f_alias[i] is not None:
                fs[i], h0s[i] = fs[an.f_alias[i]], h0s[an.f_alias[i]]
            else:
                h0 = y
                for j in range(i):
                    if tab.A0[i][j] != 0.0:
                        h0 = h0 + (tab.A0[i][j] * dt_eff) * fs[j]
                    if tab.B0[i][j] != 0.0:
                        h0 = h0 + (tab.B0[i][j] * i10) * gs[j]
                acts_f[i] = _drift_fwd(h0, layers_f, body)
                fs[i], h0s[i] = acts_f[i][-1], h0
        if an.g_used[i]:
            if an.g_alias[i] is not None:
                gs[i] = gs[an.g_alias[i]]
            else:
                h1 = y
                for j in range(i):
                    if tab.A1[i][j] != 0.0:
                        h1 = h1 + (tab.A1[i][j] * dt_eff) * fs[j]
                    if tab.B1[i][j] != 0.0:
                        h1 = h1 + (tab.B1[i][j] * sqdt) * gs[j]
                acts_g[i] = _mlp_fwd(h1, layers_g)
                gs[i] = acts_g[i][-1]
    coefs = [None] * s
    y_new = y
    for i in range(s):
        if tab.alpha[i] != 0.0:
            y_new = y_new + (tab.alpha[i] * dt_eff) * fs[i]
    for i in range(s):
        if an.g_used[i] and (tab.beta1[i], tab.beta2[i], tab.beta3[i], tab.beta4[i]) != (0.0,) * 4:
            coefs[i] = (tab.beta1[i] * dw + tab.beta2[i] * i11 + tab.beta3[i] * i10
                        + tab.beta4[i] * i111)
            y_new = y_new + coefs[i] * gs[i]
    err = zeros
    for i in range(s):
        if tab.e_drift[i] != 0.0:
            err = err + ((tab.delta * tab.e_drift[i]) * dt_eff) * fs[i]
    for i in range(s):
        if tab.e_noise[i] != 0.0:
            err = err + (tab.e_noise[i] * i10) * gs[i]
    ay, an_ = torch.abs(y), torch.abs(y_new)
    denom = atol + torch.maximum(ay, an_) * rtol
    scaled = err / denom

    # ---- seeds ----
    c_ynew = c_yout if accept else zeros
    ct_y = zeros if accept else c_yout
    if c_ynew_save is not None:
        c_ynew = c_ynew + c_ynew_save
        ct_y = ct_y + c_y_save
    # tail_out = where(accept, where(inside, tail - d, 0), d), d = frac tail + std xi
    if accept:
        c_dw, c_dz = torch.where(inside, -c_two, zeros), torch.where(inside, -c_tzo, zeros)
        ct_tw, ct_tz = torch.where(inside, c_two, zeros), torch.where(inside, c_tzo, zeros)
    else:
        c_dw, c_dz, ct_tw, ct_tz = c_two, c_tzo, zeros, zeros
    c_s = g_e * 2 * scaled
    c_err = c_s / denom
    c_m = -c_s * scaled / denom * rtol
    half = 0.5 * c_m
    ct_y = ct_y + torch.where(ay > an_, c_m, torch.where(ay == an_, half, zeros)) * torch.sign(y)
    c_ynew = c_ynew + torch.where(an_ > ay, c_m, torch.where(ay == an_, half, zeros)) * torch.sign(
        y_new)
    ct_y = ct_y + c_ynew  # y_new = y + ...
    c_f = [zeros] * s
    c_g = [zeros] * s
    c_h0 = [zeros] * s
    ia, ib = eigen_stages(tab)
    if ia != ib:
        d_f = g_n * 2 * (fs[ib] - fs[ia])
        d_h = g_d * 2 * (h0s[ib] - h0s[ia])
        c_f[ib], c_f[ia] = c_f[ib] + d_f, c_f[ia] - d_f
        c_h0[ib], c_h0[ia] = c_h0[ib] + d_h, c_h0[ia] - d_h
    p_dteff = torch.zeros_like(dt_eff)
    p_sqdt = torch.zeros_like(dt_eff)
    c_w, c_i11, c_i10, c_i111 = zeros, zeros, zeros, zeros
    for i in range(s):
        if tab.alpha[i] != 0.0:
            c_f[i] = c_f[i] + (tab.alpha[i] * dt_eff) * c_ynew
            p_dteff = p_dteff + tab.alpha[i] * torch.sum(fs[i] * c_ynew)
        if tab.e_drift[i] != 0.0:
            c_f[i] = c_f[i] + ((tab.delta * tab.e_drift[i]) * dt_eff) * c_err
            p_dteff = p_dteff + (tab.delta * tab.e_drift[i]) * torch.sum(fs[i] * c_err)
        if coefs[i] is not None:
            c_g[i] = c_g[i] + coefs[i] * c_ynew
            c_coef = gs[i] * c_ynew
            c_w = c_w + tab.beta1[i] * c_coef
            c_i11 = c_i11 + tab.beta2[i] * c_coef
            c_i10 = c_i10 + tab.beta3[i] * c_coef
            c_i111 = c_i111 + tab.beta4[i] * c_coef
        if tab.e_noise[i] != 0.0:
            c_g[i] = c_g[i] + (tab.e_noise[i] * i10) * c_err
            c_i10 = c_i10 + tab.e_noise[i] * gs[i] * c_err

    # ---- reverse over the stages ----
    c_lf = [[torch.zeros_like(W), torch.zeros_like(b)] for W, b in layers_f]
    c_lg = [[torch.zeros_like(W), torch.zeros_like(b)] for W, b in layers_g]
    for i in range(s - 1, -1, -1):
        if an.g_used[i]:
            k = an.g_alias[i]
            if k is not None:
                c_g[k] = c_g[k] + c_g[i]
            else:
                c_h1 = _mlp_bwd(acts_g[i], layers_g, c_g[i], c_lg)
                ct_y = ct_y + c_h1
                for j in range(i):
                    if tab.A1[i][j] != 0.0:
                        c_f[j] = c_f[j] + (tab.A1[i][j] * dt_eff) * c_h1
                        p_dteff = p_dteff + tab.A1[i][j] * torch.sum(fs[j] * c_h1)
                    if tab.B1[i][j] != 0.0:
                        c_g[j] = c_g[j] + (tab.B1[i][j] * sqdt) * c_h1
                        p_sqdt = p_sqdt + tab.B1[i][j] * torch.sum(gs[j] * c_h1)
        if an.f_used[i]:
            k = an.f_alias[i]
            if k is not None:
                c_f[k] = c_f[k] + c_f[i]
                c_h0[k] = c_h0[k] + c_h0[i]
            else:
                c_x = _drift_bwd(h0s[i], acts_f[i], layers_f, c_f[i], c_lf, body) + c_h0[i]
                ct_y = ct_y + c_x
                for j in range(i):
                    if tab.A0[i][j] != 0.0:
                        c_f[j] = c_f[j] + (tab.A0[i][j] * dt_eff) * c_x
                        p_dteff = p_dteff + tab.A0[i][j] * torch.sum(fs[j] * c_x)
                    if tab.B0[i][j] != 0.0:
                        c_g[j] = c_g[j] + (tab.B0[i][j] * i10) * c_x
                        c_i10 = c_i10 + tab.B0[i][j] * gs[j] * c_x

    # ---- the Itô coefficients and the bridge ----
    c_dw = c_dw + c_w + c_i11 * (dw / sqdt) + 0.5 * c_i10 + c_i111 * (
        (3.0 * dw * dw - 3.0 * dt_eff) / (6.0 * dt_eff))
    c_dz = c_dz + (0.5 / math.sqrt(3.0)) * c_i10
    p_dteff = p_dteff - torch.sum(c_i11) * (0.5 / sqdt) + torch.sum(
        c_i111 * (-3.0 * dw / (6.0 * dt_eff) - i111 / dt_eff))
    p_sqdt = p_sqdt - torch.sum(c_i11 * i11) / sqdt
    ct_tw = ct_tw + br.frac * c_dw
    ct_tz = ct_tz + br.frac * c_dz
    p_frac = torch.sum(tw * c_dw) + torch.sum(tz * c_dz)
    p_std = torch.sum(xw * c_dw) + torch.sum(xz * c_dz)
    return ct_y, ct_tw, ct_tz, c_lf, c_lg, (p_dteff, p_sqdt, p_frac, p_std)


def _sde_step_bwd_math(tab, ctrl, rtol, atol, prim, leaves, n_drift, accept, sums, cts,
                       save=None, body="mlp"):
    """Hand pullback of one trial step (``plain_sde_trial_step``): what K10
    computes, in PyTorch. ``prim = (t, dt, qold, tail_h, y, tail_w, tail_z,
    xi_w, xi_z, t1, span)``; ``accept`` and ``sums = (err_ssq, num_ssq,
    den_ssq)`` are the forward's; ``cts`` the cotangents of ``(t_new,
    dt_next, qold_next, y_out, tail_h_out, tail_w_out, tail_z_out, t_end,
    dt_eff, eest, eigen_est)``; ``save``, in a ``saveat`` solve, the
    cotangents ``(t, dt_eff, y, y_new)`` of the step's save rows. Returns
    the cotangents of ``(t, dt, qold, tail_h, y, tail_w, tail_z, t1, span)``
    and of the leaves. The draws get none."""
    t, dt, qold, h, y, tw, tz, xw, xz, t1, span = prim
    (c_tnew, c_dtn, c_qn, c_yout, c_tho, c_two, c_tzo, c_tend, c_teldt, c_eest,
     c_eig) = cts
    remaining = t1 - t
    is_last = dt >= remaining
    dt_eff = torch.where(is_last, remaining, dt)
    e, n, d = sums
    g_t, g_dteff, g_qold, g_e, g_n, g_d, g_t1, g_span = sde_post_bwd(
        ctrl, float(y.numel()), t, dt_eff, qold, e, n, d, t1, span, is_last,
        torch.as_tensor(accept, device=y.device), (c_tnew, c_dtn, c_qn, c_tend, c_eest, c_eig))
    br = sde_ops.bridge_scalars(dt_eff, h)
    layers_f, layers_g = split_pair(leaves, n_drift)
    c_ts, c_dts, c_ys, c_yns = save if save is not None else (0.0, 0.0, None, None)
    ct_y, ct_tw, ct_tz, c_lf, c_lg, (p_dteff, p_sqdt, p_frac, p_std) = _sde_rows_bwd(
        tab, rtol, atol, dt_eff, br, accept, y, tw, tz, xw, xz, layers_f, layers_g, g_e, g_n,
        g_d, c_yout, c_two, c_tzo, c_ys, c_yns, body)
    # tail_h_out = where(accept, where(inside, h - dt_eff, 0), dt_eff)
    zero = torch.zeros_like(h)
    g_h = torch.where(br.inside, c_tho, zero) if accept else zero
    g_dteff = g_dteff + (torch.where(br.inside, -c_tho, zero) if accept else c_tho)
    b_dteff, b_h = bridge_scalars_bwd(dt_eff, h, br, p_frac, p_std)
    g_dteff = (g_dteff + c_teldt + c_dts + p_dteff + p_sqdt / (2 * torch.sqrt(dt_eff))
               + b_dteff)
    g_h = g_h + b_h
    ct_t = g_t + c_ts + torch.where(is_last, -g_dteff, zero)
    ct_dt = torch.where(is_last, zero, g_dteff)
    ct_t1 = g_t1 + torch.where(is_last, g_dteff, zero)
    ct_leaves = [c for pair in (*c_lf, *c_lg) for c in pair]
    return (ct_t, ct_dt, g_qold, g_h, ct_y, ct_tw, ct_tz, ct_t1, g_span), ct_leaves


# ---------------------------------------------------------------------------
# Plain versions of K9 and K10.
# ---------------------------------------------------------------------------


def plain_sde_whole_solve_fwd(t0, t1, dt0, y0, leaves, rtol, atol, ctrl: PIController,
                              max_steps: int, xi_w, xi_z, *, n_drift: int, solver="sosri",
                              saveat=None, ys_init=None, body="mlp") -> SDERecord:
    """Plain version of K9: the trial-step loop of ``ops.sde`` over the
    pair, with the linear ``saveat`` writes, recording ``SDERecord``."""
    tab = get_tableau(solver)
    drift, diffusion = pair_functions(n_drift, body)
    step = sde_ops.make_step(tab, drift, diffusion, ctrl, rtol, atol,
                             torch.promote_types(y0.dtype, torch.float32))
    S = max_steps
    hy = y0.new_zeros((S + 1,) + tuple(y0.shape))
    hw, hz = torch.zeros_like(hy), torch.zeros_like(hy)
    streams = t0.new_zeros((N_STREAMS, S))
    span = t1 - t0
    t, dt, qold = t0, dt0, torch.full_like(t0, ctrl.qoldinit)
    tail = sde_ops.Tail(torch.zeros_like(t0), torch.zeros_like(y0), torch.zeros_like(y0))
    y, ys = y0, (ys_init if saveat is not None else None)
    na = i = 0
    done = bool(span == 0)
    while not done and i < S:
        hy[i], hw[i], hz[i] = y, tail.w, tail.z
        out = step(t, dt, qold, y, tail, ys, t1, span, saveat, tuple(leaves), xi_w[i], xi_z[i])
        streams[:, i] = torch.stack([t, dt, qold, tail.h, *out.sums,
                                     out.accept.to(t0.dtype), out.tel_t, out.dt_eff, out.eest,
                                     out.eigen_est]).to(streams.dtype)
        acc, last = torch.stack((out.accept, out.is_last)).tolist()
        na += acc
        t, dt, qold, y, tail, ys = out.t, out.dt, out.qold, out.y, out.tail, out.ys
        done = acc and last
        i += 1
    hy[i], hw[i], hz[i] = y, tail.w, tail.z
    final = torch.stack((t, dt, qold)).to(streams.dtype)
    final = torch.cat([final, final.new_tensor([na, i - na, float(done)])])
    if saveat is None:
        ys = y0.new_zeros((0,) + tuple(y0.shape))
        cursors = torch.zeros(2, dtype=torch.int32, device=y0.device)
    else:
        ys = ys.clone() if ys is ys_init else ys
        cursors = torch.stack((_rows_through(saveat, t0, 1.0), _rows_through(saveat, t, 1.0)))
    return SDERecord(y, hy, hw, hz, streams, final, ys, cursors)


def plain_sde_whole_solve_bwd(rec: SDERecord, ns: int, ct_y1, ct_tel, t0, t1, leaves, rtol,
                              atol, ctrl: PIController, xi_w, xi_z, *, n_drift: int,
                              solver="sosri", saveat=None, ct_ys=None, body="mlp"):
    """Plain version of K10: the reverse walk over ``rec``'s ``ns`` trial
    steps through ``_sde_step_bwd_math``, with the pullback of the linear
    saves (each row's cotangent to the accepted step that wrote it). ``ct_tel``
    is ``(4, S)``, the cotangents of the telemetry streams ``t, dt, eest,
    eigen_est``. Returns ``(ct_t0, ct_t1, ct_dt0, ct_y0, ct_ys_init,
    *ct_leaves)``."""
    _check_body(body)
    tab = get_tableau(solver)
    span = t1 - t0
    zero = torch.zeros_like(t0)
    ct_t = ct_dt = ct_qold = ct_th = ct_t1x = ct_spanx = zero
    ct_y, ct_tw, ct_tz = ct_y1, torch.zeros_like(ct_y1), torch.zeros_like(ct_y1)
    ct_leaves = [torch.zeros_like(x) for x in leaves]
    ct_ys = torch.zeros_like(rec.ys) if ct_ys is None else ct_ys.clone()
    st = rec.streams
    cur0, rcur = (int(v) for v in rec.cursors.tolist())
    for i in range(ns - 1, -1, -1):
        t_i, dt_i, qold_i, h_i, e, n, d, acc_f = st[:TEL_T, i]
        acc = bool(acc_f > 0.5)
        save = None
        if saveat is not None and acc:
            lo = rcur
            while lo > cur0 and bool(saveat[lo - 1] - t_i > 0):
                lo -= 1
            if lo < rcur:
                is_last = dt_i >= t1 - t_i
                dt_eff = torch.where(is_last, t1 - t_i, dt_i)
                hd = torch.where(dt_eff == 0, torch.ones_like(dt_eff), dt_eff)
                th = ((saveat[lo:rcur] - t_i) / hd).reshape((-1,) + (1,) * ct_y1.dim())
                rows = ct_ys[lo:rcur]
                c_th = (rows * (rec.hy[i + 1] - rec.hy[i])).flatten(1).sum(1)
                th1 = th.flatten()
                save = (-(c_th / hd).sum(),
                        torch.where(dt_eff == 0, zero, -(c_th * th1 / hd).sum()),
                        ((1 - th) * rows).sum(0), (th * rows).sum(0))
                ct_ys[lo:rcur] = 0
            rcur = lo
        prim = (t_i, dt_i, qold_i, h_i, rec.hy[i], rec.hw[i], rec.hz[i], xi_w[i], xi_z[i], t1,
                span)
        cts = (ct_t, ct_dt, ct_qold, ct_y, ct_th, ct_tw, ct_tz, ct_tel[0, i], ct_tel[1, i],
               ct_tel[2, i], ct_tel[3, i])
        (ct_t, ct_dt, ct_qold, ct_th, ct_y, ct_tw, ct_tz, d_t1, d_span), d_leaves = (
            _sde_step_bwd_math(tab, ctrl, rtol, atol, prim, leaves, n_drift, acc, (e, n, d),
                               cts, save, body))
        ct_t1x, ct_spanx = ct_t1x + d_t1, ct_spanx + d_span
        ct_leaves = [a + b for a, b in zip(ct_leaves, d_leaves)]
    return (ct_t - ct_spanx, ct_t1x + ct_spanx, ct_dt, ct_y, ct_ys, *ct_leaves)


# ---------------------------------------------------------------------------
# The kernels' tile plan and K10's order of sums.
# ---------------------------------------------------------------------------

SDE_ROWS = 4       # csrc/sri_mlp.cuh kSdeRows: rows of the batch a tile
SDE_CHAIN = 8      # kSdeChain: most terms of one lane's share of a sum
SDE_THREADS = 256  # threads a block
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on the H100
# the widths each pair's compile-time instance runs (csrc Pair::Fixed)
FIXED_WIDTHS = {"mlp": ((32, 64, 32), (32, 32)), "cubic": ((2, 50, 2), (2, 2))}


def _pad4(n):
    return -(-n // 4) * 4


def sde_lanes(n):
    """Lanes of a warp that share one sum of ``n`` terms in the kernels
    (``1 << sde_split_lg(n)``): the fewest, a power of two up to 32, that
    leave each lane at most ``SDE_CHAIN`` terms."""
    s = 1
    while s < 32 and -(-n // s) > SDE_CHAIN:
        s *= 2
    return s


class SDEPlan(NamedTuple):
    """K9's and K10's tile bodies at a batch and a pair's widths: ``rows`` a
    tile, ``tiles`` (the blocks, one tile each where the card holds them),
    per network and layer the lanes that share an output's sum forward
    (``fwd_lanes``) and an input cotangent's in the reverse
    (``bwd_lanes``), at most ``terms`` a lane (up to 32 lanes), each
    kernel's shared memory a block, the floats of K10's leaf cotangents
    held in it (``cw_smem``), and whether the pair's compile-time instance
    (``FIXED_WIDTHS``, its widths as constants) runs it."""
    rows: int
    tiles: int
    fwd_lanes: Tuple
    bwd_lanes: Tuple
    terms: int
    fwd_smem_bytes: int
    bwd_smem_bytes: int
    cw_smem: int
    fixed_instance: bool


def _net_widths(widths) -> Tuple:
    """``((drift widths), (diffusion widths))`` from ``_pair_widths``'
    ``[nf, ng, drift widths, diffusion widths]``."""
    w = [int(x) for x in widths]
    nf, ng = w[0], w[1]
    return tuple(w[2:3 + nf]), tuple(w[3 + nf:4 + nf + ng])


def sde_tile_plan(B, widths, body="mlp") -> SDEPlan:
    """``csrc/sde_whole_solve.cu``'s sizes (``sde_smem_floats``,
    ``sde_tile_floats``) at batch ``B`` for the pair of ``widths =
    (drift widths, diffusion widths)``; raises ``ValueError`` for a network
    of no layer or more than ``MAX_LAYERS``, ends other than the state's
    width, or shared memory past ``SMEM_LIMIT``."""
    _check_body(body)
    nets = tuple(tuple(int(x) for x in w) for w in widths)
    for w in nets:
        if not 1 <= len(w) - 1 <= MAX_LAYERS:
            raise ValueError(f"each network takes 1 to {MAX_LAYERS} layers")
    D = nets[0][0]
    if any(w[0] != D or w[-1] != D for w in nets):
        raise ValueError(f"each network must end at the state's width {D}")
    R = SDE_ROWS
    layers = [(w[l], w[l + 1]) for w in nets for l in range(len(w) - 1)]
    weights = sum(n_out * (_pad4(n_in) + 4) + _pad4(n_out) for n_in, n_out in layers)
    part = lambda floats: _pad4(floats) if floats > 0 else 4  # csrc SdeCarve's share
    n, p0 = R * D, R * _pad4(D)
    ph = [R * _pad4(max(w[1:-1], default=0)) for w in nets]  # the widest hidden layer
    hidden = [sum(R * _pad4(w[l + 1]) for l in range(len(w) - 2)) for w in nets]
    # f64 rows: layer inputs by parity; the reverse's output and hidden
    # cotangents (f64, and f32 copies) take the recompute's place
    rows64 = 4 * part(2 * p0) + sum(2 * part(2 * h) for h in ph)
    rows_bwd = rows64 + sum(2 * part(h) for h in ph)
    rest = (26 * n + part(4 * hidden[0]) + part(4 * hidden[1])
            + part(5 * SDE_THREADS // 32))
    fwd_tile = rows64 + rest
    bwd_tile = max(rows64, rows_bwd) + rest + 28 * n
    nleaf = sum(n_out * n_in + n_out for n_in, n_out in layers)
    fwd = 4 * (weights + 4 + fwd_tile)
    bwd = 4 * (weights + 4 + _pad4(nleaf) + bwd_tile)
    if max(fwd, bwd) > SMEM_LIMIT:
        raise ValueError(f"the SDE kernels' tile bodies hold at most {SMEM_LIMIT} bytes of "
                         f"shared memory; widths {nets} need {max(fwd, bwd)}")
    lanes = lambda at: tuple(tuple(sde_lanes(w[l + at]) for l in range(len(w) - 1))
                             for w in nets)
    return SDEPlan(R, -(-B // R), lanes(0), lanes(1), SDE_CHAIN, fwd, bwd, nleaf,
                   nets == FIXED_WIDTHS[body])


@functools.lru_cache(maxsize=16)
def check_sde_plan(lib, widths: Tuple, body="mlp") -> SDEPlan:
    """``sde_tile_plan`` held to the library's constants and sizes (once a
    pair of widths)."""
    plan = sde_tile_plan(0, _net_widths(widths), body)
    w = (ctypes.c_int * len(widths))(*widths)
    D, cubic = widths[2], int(body == "cubic")
    if (lib.regnde_sde_rows() != SDE_ROWS or lib.regnde_sde_chain() != SDE_CHAIN
            or lib.regnde_sde_threads() != SDE_THREADS
            or lib.regnde_sde_smem_bytes(w, D, 0) != plan.fwd_smem_bytes
            or lib.regnde_sde_smem_bytes(w, D, 1) != plan.bwd_smem_bytes
            or lib.regnde_sde_fixed_instance(w, D, cubic) != int(plan.fixed_instance)):
        raise RuntimeError("sde_tile_plan disagrees with csrc/sde_whole_solve.cu's sizes")
    return plan


def _split_sum(x, w, lanes, bias=None):
    """``x @ w.T (+ bias)`` in the kernels' order of sums: lane ``s`` of
    ``lanes`` adds, in float64 from the bias (lane 0) or zero, ``x[:, k]
    w[:, k]`` for ``k = s, s + lanes, ...`` in that order (each product of
    two float32 values exact in float64, so each addition is the kernel's
    FMA), a butterfly adds the lanes' partials pairwise, and the sum is
    rounded once to ``x``'s type."""
    xd, wd = x.double(), w.double()
    parts = []
    for s in range(lanes):
        acc = (bias.double().expand(xd.shape[0], -1) if bias is not None and s == 0
               else xd.new_zeros(xd.shape[0], wd.shape[0]))
        for k in range(s, xd.shape[1], lanes):
            acc = acc + xd[:, k, None] * wd[None, :, k]
        parts.append(acc)
    while len(parts) > 1:
        parts = [parts[j] + parts[j + 1] for j in range(0, len(parts), 2)]
    return parts[0].to(x.dtype)


def _mlp_tiles(x, layers):
    """``_mlp_fwd`` in the kernels' order of sums: the hidden activations
    and the output."""
    h, hidden = x, []
    for l, (W, b) in enumerate(layers):
        v = _split_sum(h, W, sde_lanes(W.shape[1]), b)
        if l == len(layers) - 1:
            return hidden, v
        h = torch.tanh(v)
        hidden.append(h)


def _sign_of(x):
    """The kernels' ``sign_of``: 1, -1, or 0 (also for -0)."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, torch.zeros_like(x)))


def _warp_sum(v):
    """A warp's sum of ``v[..., :32]`` as the kernels' xor butterfly adds it
    (every lane ends with lane 0's bits)."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


class _Consts:
    """The scalars K10's thread 0 and its rows take, as 0-d tensors of the
    working type (so every operation is a tensor-tensor one: ATen
    multiplies by the reciprocal of a Python divisor)."""

    def __init__(self, tab, ctrl, rtol, atol, dtype, dev):
        c = lambda x: torch.tensor(float(x), dtype=dtype, device=dev)
        self.c = c
        self.zero, self.one, self.half, self.two = c(0), c(1), c(0.5), c(2)
        self.three, self.six = c(3), c(6)
        self.tiny, self.floor = c(1e-30), c(_EEST_FLOOR)
        self.inv_sqrt3 = self.one / c(math.sqrt(3.0))
        self.rtol, self.atol = c(rtol), c(atol)
        self.beta1, self.beta2, self.qmin, self.qmax, self.gamma = (
            c(ctrl.beta1), c(ctrl.beta2), c(ctrl.qmin), c(ctrl.qmax), c(ctrl.gamma))
        self.qoldinit, self.qsteady = c(ctrl.qoldinit), c(ctrl.qsteady_max)
        self.qsteady_on = float(self.qsteady) > 1.0
        m = lambda rows: [[c(x) for x in r] for r in rows]
        self.A0, self.A1, self.B0, self.B1 = m(tab.A0), m(tab.A1), m(tab.B0), m(tab.B1)
        self.alpha = [c(x) for x in tab.alpha]
        self.beta = [[c(b[i]) for b in (tab.beta1, tab.beta2, tab.beta3, tab.beta4)]
                     for i in range(tab.stages)]
        self.dE = [c(tab.delta * e) for e in tab.e_drift]
        self.en = [c(e) for e in tab.e_noise]


def _mg(a, b, g, k, less=False):
    """Autograd's pullback of ``maximum(a, b)`` (``minimum`` where
    ``less``) to ``a``, as the kernels' ``max_grad``/``min_grad``."""
    win = bool(a < b) if less else bool(a > b)
    return g if win else (g / k.two if bool(a == b) else k.zero)


def _k_post_bwd(k, count, dt_eff, qold, e, n, d, span, is_last, accept, c_tnew, c_dtn, c_qn,
                c_tend, c_eest, c_eig):
    """``csrc/sde_whole_solve.cu`` ``sde_post_bwd`` op by op:
    ``(t, dt_eff, qold, e, n, d, t1, span)`` cotangents."""
    z = k.zero
    pe, pn, pd = bool(e > 0), bool(n > 0), bool(d > 0)
    eest = torch.sqrt(e / count) if pe else z
    num = torch.sqrt(n / count) if pn else z
    den = torch.sqrt(d / count) if pd else z
    mden = torch.maximum(den, k.tiny)
    es = torch.maximum(eest, k.floor)
    q11 = torch.pow(es, k.beta1)
    qb = torch.pow(qold, k.beta2)
    q = q11 / qb
    qg = q / k.gamma
    lo, hi = k.one / k.qmax, k.one / k.qmin
    mx = torch.maximum(qg, lo)
    qa0 = torch.minimum(mx, hi)
    in_band = k.qsteady_on and bool(qa0 >= 1.0) and bool(qa0 <= k.qsteady)
    qa = k.one if in_band else qa0
    r = q11 / k.gamma
    q_rej = torch.minimum(hi, r)
    dt0 = dt_eff / qa if accept else dt_eff / q_rej
    g_tend = c_tend + (c_tnew if accept else z)
    g_t = z if accept else c_tnew
    g_t1 = g_tend if is_last else z
    g_lin = z if is_last else g_tend
    g_t = g_t + g_lin
    g_dteff = g_lin
    g_dt0 = _mg(dt0, span, c_dtn, k, less=True)
    g_span = _mg(span, dt0, c_dtn, k, less=True)
    g_qold = z if accept else c_qn
    g_eest = c_eest + _mg(eest, k.qoldinit, c_qn if accept else z, k)
    g_acc = g_dt0 if accept else z
    g_rej = z if accept else g_dt0
    g_dteff = g_dteff + g_acc / qa + g_rej / q_rej
    g_qa = -g_acc * ((dt_eff / qa) / qa)
    g_qrej = -g_rej * ((dt_eff / q_rej) / q_rej)
    g_q11 = _mg(r, hi, g_qrej, k, less=True) / k.gamma
    g_qa0 = z if in_band else g_qa
    g_q = _mg(qg, lo, _mg(mx, hi, g_qa0, k, less=True), k) / k.gamma
    g_q11 = g_q11 + g_q / qb
    g_qb = -g_q * ((q11 / qb) / qb)
    g_qold = g_qold + g_qb * (k.beta2 * torch.pow(qold, k.beta2 - k.one))
    g_es = g_q11 * (k.beta1 * torch.pow(es, k.beta1 - k.one))
    g_eest = g_eest + _mg(eest, k.floor, g_es, k)
    g_ratio = c_eig if bool(den > 0) else z
    g_num = g_ratio / mden
    g_den = _mg(den, k.tiny, -g_ratio * ((num / mden) / mden), k)
    g_e = (g_eest / (k.two * eest)) / count if pe else z
    g_n = (g_num / (k.two * num)) / count if pn else z
    g_d = (g_den / (k.two * den)) / count if pd else z
    return g_t, g_dteff, g_qold, g_e, g_n, g_d, g_t1, g_span


def _k_bridge(k, dt_eff, h):
    """``bridge_of``: ``(inside, safe_h, frac, var0, var, std)``."""
    safe_h = torch.maximum(h, k.tiny)
    inside = bool(dt_eff < h)
    frac = dt_eff / safe_h if inside else k.one
    var0 = dt_eff * (h - dt_eff) / safe_h if inside else torch.maximum(dt_eff - h, k.zero)
    var = torch.maximum(var0, k.zero)
    std = torch.sqrt(var) if bool(var > 0) else k.zero
    return inside, safe_h, frac, var0, var, std


def _k_bridge_bwd(k, br, dt_eff, h, g_frac, g_std, g_dteff, g_h):
    """``bridge_bwd``: the updated ``(g_dteff, g_h)``."""
    inside, safe_h, _, var0, var, std = br
    z = k.zero
    gd = g_frac / safe_h if inside else z
    g_safe = -g_frac * ((dt_eff / safe_h) / safe_h) if inside else z
    g_var = g_std / (k.two * std) if bool(var > 0) else z
    g_var0 = _mg(var0, z, g_var, k)
    g_p = g_var0 / safe_h if inside else z
    p = dt_eff * (h - dt_eff)
    g_safe = g_safe - (g_var0 * ((p / safe_h) / safe_h) if inside else z)
    gd = gd + g_p * (h - dt_eff) - g_p * dt_eff
    gh = g_p * dt_eff
    g_m = _mg(dt_eff - h, z, z if inside else g_var0, k)
    return g_dteff + (gd + g_m), g_h + (gh - g_m + _mg(h, k.tiny, g_safe, k))


def plain_sde_bwd_tiles(rec: SDERecord, ns: int, ct_y1, ct_tel, t0, t1, leaves, rtol, atol,
                        ctrl: PIController, xi_w, xi_z, *, n_drift: int, solver="sosri",
                        saveat=None, ct_ys=None, body="mlp", blocks=None):
    """K10 (``csrc/sde_whole_solve.cu`` ``sde_bwd_tile`` and its kernel) in
    its own order of sums, in plain PyTorch: the reverse walk of
    ``plain_sde_whole_solve_bwd`` with the row pullback on tiles of
    ``SDE_ROWS`` rows as the kernel runs it: the recompute's affine maps and
    the input cotangents' sums split over lanes in float64
    (``_split_sum``), every row operation as the kernel orders it, each
    leaf cotangent over a tile's rows in order, stage after stage, trial
    step after trial step, in one slot a block (``blocks``, one tile each
    by default) and the slots summed in block order, the scalar partials
    over the kernel's threads, warps and tiles, and thread 0's scalar
    chain op by op. Same arguments and outputs as
    ``plain_sde_whole_solve_bwd``. For the tests: on the card K10's outputs
    equal these bitwise (the card's ATen ops round as the kernel's; on the
    CPU, ``pow`` and ``tanh`` may round otherwise)."""
    _check_body(body)
    tab = get_tableau(solver)
    an = analyze(tab)
    s_ = tab.stages
    dev, dt_ = ct_y1.device, ct_y1.dtype
    k = _Consts(tab, ctrl, rtol, atol, dt_, dev)
    f_src = [(-1 if not an.f_used[i] else (i if an.f_alias[i] is None else an.f_alias[i]))
             for i in range(s_)]
    g_src = [(-1 if not an.g_used[i] else (i if an.g_alias[i] is None else an.g_alias[i]))
             for i in range(s_)]
    coef = [an.g_used[i] and any(b[i] != 0.0 for b in (tab.beta1, tab.beta2, tab.beta3,
                                                        tab.beta4)) for i in range(s_)]
    ia, ib = eigen_stages(tab)
    R = SDE_ROWS
    B, D = ct_y1.shape
    ntiles = -(-B // R)
    Bp = ntiles * R
    grid = ntiles if blocks is None else blocks
    pad = lambda x: torch.cat([x, x.new_zeros((Bp - B,) + tuple(x.shape[1:]))]) if Bp > B else x
    valid = (torch.arange(Bp, device=dev) < B)[:, None].expand(Bp, D)
    mask = lambda x: torch.where(valid, x, torch.zeros_like(x))
    nets = split_pair(leaves, n_drift)
    cw = [[[torch.zeros((grid,) + tuple(x.shape), dtype=dt_, device=dev) for x in layer]
           for layer in net] for net in nets]
    rounds = -(-ntiles // grid)

    def add_cw(c, g, x):
        """Each block's weight (c[0]) and bias (c[1]) cotangents over its
        tiles' rows in order: c + g x and c + g, each rounded."""
        gt, xt = g.reshape(ntiles, R, -1), x.reshape(ntiles, R, -1)
        for m in range(rounds):
            tiles = torch.arange(m * grid, min((m + 1) * grid, ntiles), device=dev)
            nb = len(tiles)
            for r in range(R):
                c[0][:nb] = c[0][:nb] + gt[tiles, r, :, None] * xt[tiles, r, None, :]
                c[1][:nb] = c[1][:nb] + gt[tiles, r, :]

    def net_bwd(q, c_out, hidden, x):
        """Network q's pullback from its output cotangent: the leaves'
        cotangents into cw[q], the input's (x: the network's input)."""
        layers = nets[q]
        g = c_out
        for l in range(len(layers) - 1, -1, -1):
            W = layers[l][0]
            add_cw(cw[q][l], g, x if l == 0 else hidden[l - 1])
            cin = _split_sum(g, W.t(), sde_lanes(W.shape[0]))
            if l == 0:
                return cin
            h = hidden[l - 1]
            g = cin * (k.one - h * h)

    t0, t1 = t0.to(dt_), t1.to(dt_)
    span = t1 - t0
    count = k.c(B * D)
    z = k.zero
    ct = [z] * 6  # t, dt, qold, tail_h; the sums of the cotangents of t1, span
    ct_y, ct_tw, ct_tz = pad(ct_y1), pad(torch.zeros_like(ct_y1)), pad(torch.zeros_like(ct_y1))
    n_save = 0 if saveat is None else saveat.shape[0]
    ct_ys = rec.ys.new_zeros((0, B, D)) if not n_save else ct_ys.clone()
    cur0, curf = (int(v) for v in rec.cursors.tolist()) if n_save else (0, 0)
    rcur = curf
    st = rec.streams
    for j in range(ns):
        i = ns - 1 - j
        # ---- thread 0: the scalar chain's pullback and the step's scalars ----
        t_i, dt_i, h_i = st[ST_T, i], st[ST_DT, i], st[ST_H, i]
        is_last = bool(dt_i >= t1 - t_i)
        dt = t1 - t_i if is_last else dt_i
        acc = bool(st[ST_ACC, i] > 0.5)
        g = _k_post_bwd(k, count, dt, st[ST_QOLD, i], st[ST_E, i], st[ST_N, i], st[ST_D, i],
                        span, is_last, acc, ct[0], ct[1], ct[2], ct_tel[0, i], ct_tel[2, i],
                        ct_tel[3, i])
        br = _k_bridge(k, dt, h_i)
        inside, frac, std = br[0], br[2], br[5]
        sqdt = torch.sqrt(dt)
        lo = rcur
        if acc:
            while lo > cur0 and bool(saveat[lo - 1] - t_i > 0):
                lo -= 1
        hi, rcur = rcur, lo
        # ---- the rows: K9's load and stages ----
        y, tw, tz = pad(rec.hy[i]), pad(rec.hw[i]), pad(rec.hz[i])
        xw, xz = pad(xi_w[i]), pad(xi_z[i])
        dw, dz = frac * tw + std * xw, frac * tz + std * xz
        i11 = k.half * (dw * dw - dt) / sqdt
        i10 = k.half * (dw + dz * k.inv_sqrt3)
        i111 = (dw * dw * dw - (k.three * dt) * dw) / (k.six * dt)
        F, G, H0, H1, hf, hg = ([None] * s_ for _ in range(6))
        for q in range(s_):
            if f_src[q] == q:
                h = y
                for jj in range(q):
                    if tab.A0[q][jj] != 0.0:
                        h = h + (k.A0[q][jj] * dt) * F[f_src[jj]]
                    if tab.B0[q][jj] != 0.0:
                        h = h + (k.B0[q][jj] * i10) * G[g_src[jj]]
                H0[q] = h
                hf[q], F[q] = _mlp_tiles(h * h * h if body == "cubic" else h, nets[0])
            if g_src[q] == q:
                h = y
                for jj in range(q):
                    if tab.A1[q][jj] != 0.0:
                        h = h + (k.A1[q][jj] * dt) * F[f_src[jj]]
                    if tab.B1[q][jj] != 0.0:
                        h = h + (k.B1[q][jj] * sqdt) * G[g_src[jj]]
                H1[q] = h
                hg[q], G[q] = _mlp_tiles(h, nets[1])
        # ---- seeds, then y_new's and the error's stage weights ----
        cy = z.expand(Bp, D) if acc else ct_y
        cyn = ct_y if acc else z.expand(Bp, D)
        cdw = (-ct_tw if inside else z.expand(Bp, D)) if acc else ct_tw
        cdz = (-ct_tz if inside else z.expand(Bp, D)) if acc else ct_tz
        ctw = ct_tw if acc and inside else z.expand(Bp, D)
        ctz = ct_tz if acc and inside else z.expand(Bp, D)
        e0 = e1 = z.expand(Bp, D)
        if hi > lo:
            ynv = pad(rec.hy[i + 1])
            hd = k.one if bool(dt == 0) else dt
            for r in range(lo, hi):
                th = (saveat[r].to(dt_) - t_i) / hd
                gr = pad(ct_ys[r])
                cy = cy + (k.one - th) * gr
                cyn = cyn + th * gr
                c_th = gr * (ynv - y)
                e0 = e0 - c_th / hd
                e1 = e1 + (z if bool(dt == 0) else -c_th * th / hd)
        yn = y
        for q in range(s_):
            if tab.alpha[q] != 0.0:
                yn = yn + (k.alpha[q] * dt) * F[f_src[q]]
        for q in range(s_):
            if coef[q]:
                b = k.beta[q]
                yn = yn + (b[0] * dw + b[1] * i11 + b[2] * i10 + b[3] * i111) * G[g_src[q]]
        er = z.expand(Bp, D)
        for q in range(s_):
            if k.dE[q] != 0.0:
                er = er + (k.dE[q] * dt) * F[f_src[q]]
        for q in range(s_):
            if tab.e_noise[q] != 0.0:
                er = er + (k.en[q] * i10) * G[g_src[q]]
        ay, an_ = torch.abs(y), torch.abs(yn)
        denom = k.atol + torch.maximum(ay, an_) * k.rtol
        sv = er / denom
        csv = g[3] * k.two * sv
        cm = -csv * sv / denom * k.rtol
        half_cm = k.half * cm
        cy = cy + torch.where(ay > an_, cm, torch.where(ay == an_, half_cm, z)) * _sign_of(y)
        cyn = cyn + torch.where(an_ > ay, cm, torch.where(ay == an_, half_cm, z)) * _sign_of(yn)
        cerr = csv / denom
        cy = cy + cyn
        cF = [z.expand(Bp, D)] * s_
        cG, cH0 = list(cF), list(cF)
        if ia != ib:
            df = g[4] * k.two * (F[ib] - F[ia])
            dh = g[5] * k.two * (H0[ib] - H0[ia])
            cF[ib], cF[ia], cH0[ib], cH0[ia] = df, -df, dh, -dh
        cwi = c11 = c10 = c111 = z.expand(Bp, D)
        for q in range(s_):
            if tab.alpha[q] != 0.0:
                cF[f_src[q]] = cF[f_src[q]] + (k.alpha[q] * dt) * cyn
                e1 = e1 + k.alpha[q] * (F[f_src[q]] * cyn)
            if k.dE[q] != 0.0:
                cF[f_src[q]] = cF[f_src[q]] + (k.dE[q] * dt) * cerr
                e1 = e1 + k.dE[q] * (F[f_src[q]] * cerr)
            gi = G[g_src[q]] if g_src[q] >= 0 else z.expand(Bp, D)
            if coef[q]:
                b = k.beta[q]
                co = b[0] * dw + b[1] * i11 + b[2] * i10 + b[3] * i111
                cG[g_src[q]] = cG[g_src[q]] + co * cyn
                cc = gi * cyn
                cwi, c11 = cwi + b[0] * cc, c11 + b[1] * cc
                c10, c111 = c10 + b[2] * cc, c111 + b[3] * cc
            if tab.e_noise[q] != 0.0:
                cG[g_src[q]] = cG[g_src[q]] + (k.en[q] * i10) * cerr
                c10 = c10 + k.en[q] * (gi * cerr)
        # past the batch end: no seed
        cy, cyn, cerr, cdw, cdz, ctw, ctz, cwi, c11, c10, c111, e0, e1 = map(
            mask, (cy, cyn, cerr, cdw, cdz, ctw, ctz, cwi, c11, c10, c111, e0, e1))
        cF, cG, cH0 = ([mask(x) for x in xs] for xs in (cF, cG, cH0))
        e2 = z.expand(Bp, D)
        # ---- reverse over the stages: the diffusion's lincomb, then the drift's ----
        for q in range(s_ - 1, -1, -1):
            cxg = net_bwd(1, cG[q], hg[q], H1[q]) if g_src[q] == q else None
            cxf = None
            if f_src[q] == q:
                cxf = net_bwd(0, cF[q], hf[q], H0[q] * H0[q] * H0[q] if body == "cubic"
                              else H0[q])
                if body == "cubic":
                    cxf = cxf * (k.three * (H0[q] * H0[q]))
                cxf = cxf + cH0[q]
            if cxg is not None:
                cy = cy + cxg
                for jj in range(q):
                    if tab.A1[q][jj] != 0.0:
                        cF[f_src[jj]] = cF[f_src[jj]] + (k.A1[q][jj] * dt) * cxg
                        e1 = e1 + k.A1[q][jj] * (F[f_src[jj]] * cxg)
                    if tab.B1[q][jj] != 0.0:
                        cG[g_src[jj]] = cG[g_src[jj]] + (k.B1[q][jj] * sqdt) * cxg
                        e2 = e2 + k.B1[q][jj] * (G[g_src[jj]] * cxg)
            if cxf is not None:
                cy = cy + cxf
                for jj in range(q):
                    if tab.A0[q][jj] != 0.0:
                        cF[f_src[jj]] = cF[f_src[jj]] + (k.A0[q][jj] * dt) * cxf
                        e1 = e1 + k.A0[q][jj] * (F[f_src[jj]] * cxf)
                    if tab.B0[q][jj] != 0.0:
                        cG[g_src[jj]] = cG[g_src[jj]] + (k.B0[q][jj] * i10) * cxf
                        c10 = c10 + k.B0[q][jj] * (G[g_src[jj]] * cxf)
        # ---- the Itô coefficients and the bridge ----
        cdw = (cdw + cwi + c11 * (dw / sqdt) + k.half * c10
               + c111 * ((k.three * dw * dw - k.three * dt) / (k.six * dt)))
        cdz = cdz + (k.half * k.inv_sqrt3) * c10
        terms = (e0, e1, e2,
                 -c11 * (k.half / sqdt) + c111 * (-k.three * dw / (k.six * dt) - i111 / dt),
                 -c11 * i11 / sqdt, tw * cdw + tz * cdz, xw * cdw + xz * cdz)
        # each thread's partials over its elements (idx = thread, thread +
        # 256, ... of the tile's valid ones), then block_sum_to's warps
        n = R * D
        flat = [x.reshape(ntiles, n) for x in terms]
        ok = valid.reshape(ntiles, n)
        part = z.expand(ntiles, 5, SDE_THREADS).clone()
        for r0 in range(0, n, SDE_THREADS):
            w_ = min(SDE_THREADS, n - r0)
            m_ = ok[:, r0:r0 + w_]
            for qq, src in ((0, 0), (1, 1), (2, 2), (1, 3), (2, 4), (3, 5), (4, 6)):
                cur = part[:, qq, :w_]
                part[:, qq, :w_] = torch.where(m_, cur + flat[src][:, r0:r0 + w_], cur)
        tile_part = z.expand(ntiles, 5)
        for w in range(SDE_THREADS // 32):
            tile_part = tile_part + _warp_sum(part[:, :, 32 * w:32 * w + 32])
        lanes = z.expand(5, 32).clone()
        for t in range(ntiles):
            lanes[:, t % 32] = lanes[:, t % 32] + tile_part[t]
        ks = _warp_sum(lanes)
        ct_y = cy
        ct_tw, ct_tz = ctw + frac * cdw, ctz + frac * cdz
        # ---- thread 0: the tile sums' pullback ----
        g_t, g_dt, g_q, _, _, _, g_t1, g_sp = g
        c_th = ct[3]
        g_dteff = g_dt + ct_tel[1, i] + ks[1] + ks[2] / (k.two * sqdt)
        g_h = z
        if acc:
            if inside:
                g_h = g_h + c_th
                g_dteff = g_dteff - c_th
        else:
            g_dteff = g_dteff + c_th
        g_dteff, g_h = _k_bridge_bwd(k, br, dt, h_i, ks[3], ks[4], g_dteff, g_h)
        ct = [g_t + ks[0] + (-g_dteff if is_last else z), z if is_last else g_dteff, g_q, g_h,
              ct[4] + g_t1 + (g_dteff if is_last else z), ct[5] + g_sp]
    if n_save:
        ct_ys[cur0:curf] = 0
    ct_leaves = []
    for net in cw:
        for layer in net:
            for slots in layer:
                tot = torch.zeros_like(slots[0])
                for b in range(grid):
                    tot = tot + slots[b]
                ct_leaves.append(tot)
    return (ct[0] - ct[5], ct[4] + ct[5], ct[1], ct_y[:B], ct_ys, *ct_leaves)


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, kernel for CUDA tensors.
# ---------------------------------------------------------------------------


def _tableau_arrays(tab: SRITableau):
    """The tableau as the kernels read it (``csrc/sde_whole_solve.cu``
    ``pack_tab``): float32 coefficients (``delta * e_drift`` multiplied in
    double first) and the stage analysis."""
    an = analyze(tab)
    s = tab.stages
    if s != 4:
        raise ValueError(f"the SDE kernels take 4-stage tableaus, got {tab.name} ({s})")
    f = [x for m in (tab.A0, tab.A1, tab.B0, tab.B1) for row in m for x in row]
    f += list(tab.alpha)
    f += [b[i] for i in range(s) for b in (tab.beta1, tab.beta2, tab.beta3, tab.beta4)]
    f += [tab.delta * e for e in tab.e_drift] + list(tab.e_noise)
    src = lambda used, alias: [(-1 if not used[i] else (i if alias[i] is None else alias[i]))
                               for i in range(s)]
    coef = [int(an.g_used[i] and (tab.beta1[i], tab.beta2[i], tab.beta3[i], tab.beta4[i])
                != (0.0,) * 4) for i in range(s)]
    ints = src(an.f_used, an.f_alias) + src(an.g_used, an.g_alias) + coef + [0] * (3 * s)
    ints += list(eigen_stages(tab))
    return (ctypes.c_float * len(f))(*f), (ctypes.c_int * len(ints))(*ints)


def _pair_widths(leaves, n_drift, D):
    """``[nf, ng, drift widths, diffusion widths]`` from the leaves' shapes,
    after checking them (2-D weights, 1-D biases, chained widths, D at both
    ends, at most MAX_LAYERS layers each)."""
    layers_f, layers_g = split_pair(leaves, n_drift)
    widths = [len(layers_f), len(layers_g)]
    for layers in (layers_f, layers_g):
        if not 1 <= len(layers) <= MAX_LAYERS:
            raise ValueError(f"each network takes 1 to {MAX_LAYERS} layers")
        w = [D]
        for W, b in layers:
            if W.dim() != 2 or W.shape[1] != w[-1] or tuple(b.shape) != (W.shape[0],):
                raise ValueError("the leaves must chain as nn.Linear layers from width "
                                 f"{D}: got {tuple(W.shape)} and {tuple(b.shape)}")
            w.append(W.shape[0])
        if w[-1] != D:
            raise ValueError(f"each network must end at the state's width {D}")
        widths += w
    return (ctypes.c_int * len(widths))(*widths)


def _check_cuda_args(y, leaves, n_drift, xi_w, xi_z, max_steps):
    if y.dim() != 2:
        raise ValueError(f"the state must be (batch, dim), got {tuple(y.shape)}")
    B, D = y.shape
    _check_tensor("the state", y, (B, D), y)
    for j, x in enumerate(leaves):
        _check_tensor(f"leaf {j}", x, tuple(x.shape), y)
    for name, x in (("xi_w", xi_w), ("xi_z", xi_z)):
        _check_tensor(name, x, (max_steps, B, D), y)
    return B, D, _pair_widths(leaves, n_drift, D)


def _kernel_name(body, direction):
    """K9's or K10's name for the tile body (``LAUNCHES``' key)."""
    _check_body(body)
    return f"sde_whole_solve{'_cubic' if body == 'cubic' else ''}_{direction}"


def _cuda_sde_fwd(t0, t1, dt0, y0, leaves, rtol, atol, ctrl, max_steps, xi_w, xi_z, n_drift,
                  solver, saveat, ys_init, body):
    from regneuralde_tpu_torch.ops import _cuda

    if max_steps < 1:
        raise ValueError(f"max_steps must be positive, got {max_steps}")
    B, D, widths = _check_cuda_args(y0, leaves, n_drift, xi_w, xi_z, max_steps)
    tab_f, tab_i = _tableau_arrays(get_tableau(solver))
    n_save = 0 if saveat is None else saveat.shape[0]
    dev = y0.device
    if n_save:
        _check_tensor("saveat", saveat, (n_save,), y0)
        _check_tensor("ys_init", ys_init, (n_save, B, D), y0)
        ys = ys_init.clone()
        cursors = torch.stack((_rows_through(saveat, t0.to(saveat.dtype), 1.0),
                               torch.zeros((), dtype=torch.int32, device=dev)))
    else:
        ys = y0.new_zeros((0, B, D))
        cursors = torch.zeros(2, dtype=torch.int32, device=dev)
    plan = sde_tile_plan(B, _net_widths(widths), body)
    lib = _cuda.library()
    check_sde_plan(lib, tuple(widths), body)
    y1 = torch.empty_like(y0)
    hy = torch.empty((max_steps + 1, B, D), device=dev)
    hw, hz = torch.empty_like(hy), torch.empty_like(hy)
    streams = torch.zeros((N_STREAMS, max_steps), device=dev)
    final = torch.empty(6, device=dev)
    partials = torch.empty((2, plan.tiles, 3), device=dev)
    save = (_ptr(saveat), _ptr(cursors), _ptr(ys)) if n_save else (None,) * 3
    scalars = torch.stack([_scalar_f32(x, y0) for x in (t0, t1, dt0)])
    code = getattr(lib, "regnde_" + _kernel_name(body, "fwd"))(
        _ptr(scalars), _ptr(y0),
        ctypes.cast(_leaf_pointers(leaves), ctypes.c_void_p), ctypes.cast(widths, ctypes.c_void_p),
        ctypes.cast(tab_f, ctypes.c_void_p), ctypes.cast(tab_i, ctypes.c_void_p), _ptr(xi_w),
        _ptr(xi_z), *save, _ptr(y1), _ptr(hy), _ptr(hw), _ptr(hz), _ptr(streams), _ptr(final),
        _ptr(partials), B, D, max_steps, n_save, float(rtol), float(atol), *_ctrl_args(ctrl),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _cuda.check(code, "SDE whole-solve forward kernel")
    LAUNCHES[_kernel_name(body, "fwd")] += 1
    return SDERecord(y1, hy, hw, hz, streams, final, ys, cursors)


def _cuda_sde_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, rtol, atol, ctrl, xi_w, xi_z,
                  n_drift, solver, saveat, ct_ys, body):
    from regneuralde_tpu_torch.ops import _cuda

    S = rec.streams.shape[1]
    B, D, widths = _check_cuda_args(rec.y1, leaves, n_drift, xi_w, xi_z, S)
    tab_f, tab_i = _tableau_arrays(get_tableau(solver))
    for name, x, shape in (("ct_y1", ct_y1, (B, D)), ("ct_tel", ct_tel, (4, S)),
                           ("hy", rec.hy, (S + 1, B, D)), ("hw", rec.hw, (S + 1, B, D)),
                           ("hz", rec.hz, (S + 1, B, D)),
                           ("streams", rec.streams, (N_STREAMS, S))):
        _check_tensor(name, x, shape, rec.y1)
    if not 0 <= ns <= S:
        raise ValueError(f"ns must lie in [0, {S}], got {ns}")
    n_save = 0 if saveat is None else saveat.shape[0]
    dev = rec.y1.device
    if n_save:
        _check_tensor("saveat", saveat, (n_save,), rec.y1)
        _check_tensor("ct_ys", ct_ys, (n_save, B, D), rec.y1)
        _check_tensor("cursors", rec.cursors, (2,), rec.y1, torch.int32)
        ct_ys = ct_ys.clone()
    else:
        ct_ys = rec.y1.new_zeros((0, B, D))
    plan = sde_tile_plan(B, _net_widths(widths), body)
    lib = _cuda.library()
    check_sde_plan(lib, tuple(widths), body)
    ct_y = ct_y1.clone()
    ct_tw, ct_tz = torch.zeros_like(ct_y), torch.zeros_like(ct_y)
    ct_scalars = torch.empty(3, device=dev)
    partials = torch.empty((2, plan.tiles, 5), device=dev)
    n_leaf = sum(x.numel() for x in leaves)
    out = torch.empty(n_leaf, device=dev)
    slots = torch.empty((plan.tiles, n_leaf), device=dev)
    save = (_ptr(saveat), _ptr(rec.cursors), _ptr(ct_ys)) if n_save else (None,) * 3
    scalars = torch.stack([_scalar_f32(x, rec.y1) for x in (t0, t1)])
    code = getattr(lib, "regnde_" + _kernel_name(body, "bwd"))(
        _ptr(scalars), _ptr(rec.streams), _ptr(rec.hy), _ptr(rec.hw), _ptr(rec.hz), ctypes.cast(_leaf_pointers(leaves), ctypes.c_void_p),
        ctypes.cast(widths, ctypes.c_void_p), ctypes.cast(tab_f, ctypes.c_void_p),
        ctypes.cast(tab_i, ctypes.c_void_p), _ptr(xi_w), _ptr(xi_z), *save, _ptr(ct_tel),
        _ptr(ct_y), _ptr(ct_tw), _ptr(ct_tz), _ptr(out), _ptr(ct_scalars), _ptr(partials),
        _ptr(slots), ns, B, D, S, n_save, float(rtol), float(atol), *_ctrl_args(ctrl),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _cuda.check(code, "SDE whole-solve backward kernel")
    LAUNCHES[_kernel_name(body, "bwd")] += 1
    ct_leaves, off = [], 0
    for x in leaves:
        ct_leaves.append(out[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return (ct_scalars[0], ct_scalars[1], ct_scalars[2], ct_y, ct_ys, *ct_leaves)


def sde_whole_solve_fwd(t0, t1, dt0, y0, leaves: Sequence[torch.Tensor], rtol, atol,
                        ctrl: PIController, max_steps: int, xi_w, xi_z, *, n_drift: int,
                        solver="sosri", saveat=None, ys_init=None, body="mlp") -> SDERecord:
    """K9 or its plain version: the whole forward solve of the pair
    (``leaves``: the drift's ``n_drift`` layers' ``(W, b)``, then the
    diffusion's; ``body`` as ``BODIES``), writing the ``saveat`` rows over
    ``ys_init`` (by default ``y0`` at the stamps at or before ``t0``)."""
    if saveat is not None and ys_init is None:
        saveat, ys_init = sde_ops.save_rows_at_start(saveat, t0, y0)
    args = (t0, t1, dt0, y0, tuple(leaves), rtol, atol, ctrl, max_steps, xi_w, xi_z)
    if y0.device.type == "cuda":
        return _cuda_sde_fwd(*args, n_drift, solver, saveat, ys_init, body)
    if y0.device.type == "cpu":
        return plain_sde_whole_solve_fwd(*args, n_drift=n_drift, solver=solver, saveat=saveat,
                                         ys_init=ys_init, body=body)
    raise RuntimeError(f"no SDE whole-solve forward for device {y0.device}")


def sde_whole_solve_bwd(rec: SDERecord, ns: int, ct_y1, ct_tel, t0, t1,
                        leaves: Sequence[torch.Tensor], rtol, atol, ctrl: PIController, xi_w,
                        xi_z, *, n_drift: int, solver="sosri", saveat=None, ct_ys=None,
                        body="mlp"):
    """K10 or its plain version: ``(ct_t0, ct_t1, ct_dt0, ct_y0, ct_ys_init,
    *ct_leaves)``."""
    args = (rec, ns, ct_y1, ct_tel, t0, t1, tuple(leaves), rtol, atol, ctrl, xi_w, xi_z)
    if ct_y1.device.type == "cuda":
        return _cuda_sde_bwd(*args, n_drift, solver, saveat, ct_ys, body)
    if ct_y1.device.type == "cpu":
        return plain_sde_whole_solve_bwd(*args, n_drift=n_drift, solver=solver,
                                         saveat=saveat, ct_ys=ct_ys, body=body)
    raise RuntimeError(f"no SDE whole-solve backward for device {ct_y1.device}")


# ---------------------------------------------------------------------------
# The differentiable solve and its sdeint-compatible front end.
# ---------------------------------------------------------------------------


class SDEWholeSolveFn(torch.autograd.Function):
    """The whole SDE solve with K10 as its gradient. Inputs ``t0, t1,
    dt_init, y0``, the ``saveat`` rows' initial values ``ys_init`` and the
    leaves; outputs those of ``ops.sde.SDEAdjointSolve``."""

    @staticmethod
    def forward(ctx, cfg, saveat, xi_w, xi_z, t0, t1, dt_init, y0, ys_init, *leaves):
        solver, n_drift, ctrl, max_steps, rtol, atol, body = cfg
        unsorted = None
        if saveat is not None:
            unsorted = (saveat[1:] < saveat[:-1]).any()
        rec = sde_whole_solve_fwd(t0, t1, dt_init, y0, leaves, rtol, atol, ctrl, max_steps,
                                  xi_w, xi_z, n_drift=n_drift, solver=solver, saveat=saveat,
                                  ys_init=ys_init if saveat is not None else None, body=body)
        # the one host sync of the solve: the step counts size the backward
        flags = rec.final[3:]
        if unsorted is not None:
            flags = torch.cat([flags, unsorted.to(flags.dtype).reshape(1)])
        na, nr, done, *bad = (int(v) for v in flags.tolist())
        if any(bad):
            raise ValueError("the SDE whole solve takes saveat sorted; sort it or use "
                             "fused=False")
        st = rec.streams
        accepted = st[ST_ACC] > 0.5
        live = torch.arange(max_steps, device=st.device) < na + nr
        counts = torch.tensor([na, nr, done])
        ctx.mark_non_differentiable(accepted, live, counts)
        ctx.rec, ctx.ns, ctx.cfg, ctx.saveat = rec, na + nr, cfg, saveat
        ctx.save_for_backward(t0, t1, xi_w, xi_z, *leaves)
        return (rec.y1, rec.ys, st[TEL_T].clone(), st[TEL_DT].clone(), st[TEL_EEST].clone(),
                st[TEL_EIGEN].clone(), accepted, live, counts)

    @staticmethod
    def backward(ctx, ct_y1, ct_ys, ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g, *_):
        t0, t1, xi_w, xi_z, *leaves = ctx.saved_tensors
        solver, n_drift, ctrl, max_steps, rtol, atol, body = ctx.cfg
        rec = ctx.rec
        S = rec.streams.shape[1]
        ct_tel = torch.stack([rec.streams.new_zeros(S) if c is None else c.to(rec.streams.dtype)
                              for c in (ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g)])
        ct_y1 = torch.zeros_like(rec.y1) if ct_y1 is None else ct_y1.contiguous()
        ct_ys = torch.zeros_like(rec.ys) if ct_ys is None else ct_ys.contiguous()
        grads = sde_whole_solve_bwd(rec, ctx.ns, ct_y1, ct_tel, t0, t1, leaves, rtol, atol,
                                    ctrl, xi_w, xi_z, n_drift=n_drift, solver=solver,
                                    saveat=ctx.saveat, ct_ys=ct_ys, body=body)
        ctx.rec = None
        ct_t0, ct_t1, ct_dt0 = (g.to(t0.dtype).reshape(t0.shape) for g in grads[:3])
        ct_ys_init = grads[4] if ctx.saveat is not None else None
        return (None,) * 4 + (ct_t0, ct_t1, ct_dt0, grads[3], ct_ys_init, *grads[5:])


def whole_solve_sdeint(y0: torch.Tensor, t0, t1, leaves, *, n_drift: int, noise=None,
                       generator: Optional[torch.Generator] = None, solver: str = "sosri",
                       rtol: float = 1e-2, atol: float = 1e-2, dt0: Optional[float] = None,
                       max_steps: int = 256, saveat=None,
                       controller: Optional[PIController] = None,
                       body: str = "mlp") -> sde_ops.SDESolution:
    """Integrate the pair's SDE (``leaves``: the drift's ``n_drift``
    layers, then the diffusion's; ``body`` as ``BODIES``) from ``t0`` to
    ``t1`` in one forward and one backward launch, with ``ops.sde.sdeint``'s
    prologue (the draws from ``noise`` or ``generator``, ``dt0 = min(0.01,
    span)``): the solution, its NFE, telemetry and ``saveat`` rows are those
    ``sdeint`` returns on the same draws."""
    _check_body(body)
    sde_ops.check_options(solver, "adjoint", "collapse")
    tab = get_tableau(solver)
    ctrl = controller or PIController(beta1=0.5, beta2=0.0)
    leaves = tuple(leaves)
    t0, t1, dt_init = sde_ops.sde_prologue(y0, t0, t1, dt0)
    xi_w, xi_z = sde_ops.resolve_noise(noise, generator, y0, max_steps)
    xi_w, xi_z = xi_w[:max_steps].contiguous(), xi_z[:max_steps].contiguous()
    if saveat is not None:
        saveat, ys_init = sde_ops.save_rows_at_start(saveat, t0, y0)
    else:
        ys_init = y0.new_zeros((0,) + tuple(y0.shape))
    (y1, ys, tel_t, tel_dt, tel_e, tel_g, acc, live, counts) = SDEWholeSolveFn.apply(
        (solver, n_drift, ctrl, max_steps, float(rtol), float(atol), body), saveat, xi_w, xi_z, t0,
        t1, dt_init, y0, ys_init, *leaves)
    naccept, nreject, done = counts.tolist()
    return sde_ops.SDESolution(
        y1=y1, ys=ys if saveat is not None else None, ts=saveat,
        stats=sde_ops.sde_stats(tab, naccept, nreject, done),
        telemetry=StepTelemetry(tel_t, tel_dt, tel_e, tel_g, acc, live))
