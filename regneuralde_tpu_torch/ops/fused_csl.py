"""Normed Tsit5 trial step of FFJORD's augmented CSL dynamics: plain PyTorch
and CUDA kernels.

Counterpart of the CSL part of ``regneuralde_tpu/ops/pallas_generic.py``
(``csl_aug_leaves``, ``csl_aug_apply``, ``csl_unflatten_cts``,
``make_csl_ffjord_sweep``). FFJORD integrates the augmented state ``u = [z;
logp]`` (``[z; logp; int |f|^2; int |eJ|^2]`` with the kinetic terms) of
``CSLDynamics``: three ConcatSquashLinear layers

    o_l = (h W_l^T + b_l) * sigmoid(t w_g,l) + (t w_b,l + b_b,l)

with softplus between them, and the analytic Hutchinson product ``eJ = e^T
df/dz`` through the chain ``v -> v (W_l * g_l)`` with ``sigmoid(o_l)``
between the hops. The stage derivative is ``[f, -sum(eJ e) (, sum f^2, sum
eJ^2)]``.

The leaves are the 15 parameters of ``CSLDynamics`` in ``parameters()``
order (per layer ``layer.weight, layer.bias, gate.weight, bias.weight,
bias.bias``, in the ``nn.Linear`` layout) followed by the probe ``e``, a
row-aligned leaf of shape ``(batch, dim)``. Nothing differentiates with
respect to the probe (it is a per-solve draw): its cotangent is returned as
zeros, as JAX drops it. ``dim`` comes from the first weight, the kinetic
terms from the state's width (``dim + 1`` or ``dim + 3``).

Each direction has a plain version and a CUDA kernel (``csrc/csl_tsit5.cu``,
tile bodies in ``csrc/csl_tsit5.cuh``, shared with the whole solve K3/K4):
K7-CSL's plain version is ``plain_csl_normed_sweep``, K8-CSL's is
``_csl_bwd_math``, the hand pullback the kernel runs (the JAX kernel traces
``jax.vjp`` instead). The pullback is second order: the forward already
holds the ``eJ`` product, so it carries ``sigmoid' = s (1 - s)`` in the hops,
the weights' second use inside ``W * g`` and the gates' and time-biases'
dependence on ``t``. The wrappers take the plain version for tensors on the
CPU, launch the kernel for tensors on a CUDA device, and raise otherwise.

Rounding. Each affine map and each hop is summed in float64 and rounded
once, each row sum (the trace and the kinetic terms) too, and every other
op rounds on its own (``W * g`` is a float32 product first, as in JAX), so
that the kernels reproduce the forward bitwise: at FFJORD's tolerances the
error estimate sits near its float32 rounding floor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from regneuralde_tpu_torch.ops.fused_generic import _leaf_pointers
from regneuralde_tpu_torch.ops.fused_mlp import _ptr, _scalar_f32, _stage_acc
from regneuralde_tpu_torch.ops.math import sigmoid, softplus
from regneuralde_tpu_torch.ops.ode import (NormedSweep, _max_grad, normed_terms,
                                          plain_normed_sweep)
from regneuralde_tpu_torch.ops.tableaus import TSIT5

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"csl_tsit5_fwd": 0, "csl_tsit5_bwd": 0}

N_PARAMS = 15  # 3 layers x (W, b, w_g, w_b, b_b)
LEAF_NAMES = [f"csl{i}.{p}" for i in (1, 2, 3) for p in
              ("layer.weight", "layer.bias", "gate.weight", "bias.weight", "bias.bias")]


# K8-CSL's and K4-CSL's reverse tile body (csrc/csl_tsit5.cuh
# csl_reverse_tile): rows a tile (kCslBwdRows), the most 4 x 4
# weight-cotangent tiles it holds in registers (kCslCwTiles x kThreads), and
# the shared memory a block may take on the H100.
CSL_BWD_ROWS = 8
CSL_BWD_MAX_TILES = 5 * 256
SMEM_LIMIT = 232_448
# K7-CSL's and K3-CSL's forward tile body (csl_forward_tile): rows a tile
# (the reverse's), rows a norm-sum slot (kCslSlotRows), threads a block.
CSL_FWD_ROWS = 8
CSL_SLOT_ROWS = 2
_THREADS = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# CSL leaves and the augmented dynamics.
# ---------------------------------------------------------------------------


def csl_aug_leaves(dynamics, e: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The leaves of the augmented dynamics: the dynamics' ``parameters()``
    and the probe ``e`` (for ``models.basic.CSLDynamics``, the kernels'
    order)."""
    return (*dynamics.parameters(), e)


def csl_unflatten_cts(d_leaves) -> dict:
    """Cotangents of the 15 parameters by name (``csl1.layer.weight``,
    ...), dropping the probe's."""
    return dict(zip(LEAF_NAMES, d_leaves[:N_PARAMS]))


def csl_dims(y, leaves):
    """``(D, H, kinetic)`` of a CSL solve: ``dim`` and ``hidden`` from the
    first weight, the kinetic terms from the state's width."""
    if len(leaves) != N_PARAMS + 1:
        raise ValueError(f"CSL takes {N_PARAMS} parameters and the probe, "
                         f"got {len(leaves)} leaves")
    H, D = leaves[0].shape
    extra = y.shape[-1] - D
    if extra not in (1, 3):
        raise ValueError(f"the augmented state is dim + 1 or dim + 3 wide "
                         f"(dim {D}), got {y.shape[-1]}")
    return D, H, extra == 3


def _f64(x):
    return x.to(torch.float64)


def _affine(h, W, b):
    """``h W^T + b`` summed in float64 and rounded once to ``h``'s type:
    the correctly rounded sum (up to a rare double rounding), whatever the
    summation order, so the kernels agree bitwise."""
    return torch.addmm(_f64(b), _f64(h), _f64(W).T).to(h.dtype)


def _hop(v, Wg):
    """``v Wg`` summed in float64 and rounded once (``Wg = W * g`` was
    rounded to float32 first)."""
    return (_f64(v) @ _f64(Wg)).to(v.dtype)


def _rowdot(a, b):
    """``sum(a * b, -1)`` of each row, summed in float64, rounded once."""
    return (_f64(a) * _f64(b)).sum(-1, keepdim=True).to(a.dtype)


def _layer(t, h, W, b, wg, wb, bb):
    """One ConcatSquashLinear layer: ``(a, g, o)`` with ``a = h W^T + b``,
    the gate ``g = sigmoid(t w_g)`` and ``o = a g + (t w_b + b_b)``."""
    g = sigmoid(t * wg.reshape(-1))
    a = _affine(h, W, b)
    return a, g, a * g + (t * wb.reshape(-1) + bb)


def _csl_forward(t, z, params, e):
    """``CSLDynamics.forw_n_back`` over the parameters: ``(mz, eJ)`` and
    the activations the pullback reads, ``(a1, g1, o1, a2, g2, o2, a3, g3,
    v3, v2)``."""
    W1, W2, W3 = params[0], params[5], params[10]
    a1, g1, o1 = _layer(t, z, *params[0:5])
    a2, g2, o2 = _layer(t, softplus(o1), *params[5:10])
    a3, g3, mz = _layer(t, softplus(o2), *params[10:15])
    v3 = _hop(e, W3 * g3[:, None])
    v2 = _hop(v3 * sigmoid(o2), W2 * g2[:, None])
    eJ = _hop(v2 * sigmoid(o1), W1 * g1[:, None])
    return mz, eJ, (a1, g1, o1, a2, g2, o2, a3, g3, v3, v2)


def csl_forw_n_back(t, z, params, e):
    """``(f(z, t), eJ)`` of CSLDynamics over its 15 parameters: the forward
    value and the analytic ``e^T J`` (``models/basic.py`` ``forw_n_back``)."""
    mz, eJ, _ = _csl_forward(t, z, params, e)
    return mz, eJ


def aug_out(mz, eJ, e, kinetic):
    cols = [mz, -_rowdot(eJ, e)]
    if kinetic:
        cols += [_rowdot(mz, mz), _rowdot(eJ, eJ)]
    return torch.cat(cols, dim=-1)


def csl_aug_apply(dim: int, kinetic: bool) -> Callable:
    """``f(t, u, leaves)`` of FFJORD's augmented dynamics over the CSL
    leaves and the probe: ``[mz, -sum(eJ e) (, sum mz^2, sum eJ^2)]``; only
    ``z = u[:, :dim]`` feeds the network."""

    def apply_fn(t, u, leaves):
        e = leaves[N_PARAMS]
        mz, eJ = csl_forw_n_back(t, u[:, :dim], leaves[:N_PARAMS], e)
        return aug_out(mz, eJ, e, kinetic)

    return apply_fn


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def plain_csl_normed_sweep(t, dt, y, k1, leaves, rtol, atol) -> NormedSweep:
    """Plain version of K7-CSL: ``(y_new, k7, err_ssq, num_ssq, den_ssq)``,
    the algebra of ``pallas_generic._stage_algebra`` over ``csl_aug_apply``.
    The kernel's order of sums is ``plain_csl_fwd_tiles``."""
    D, _, kinetic = csl_dims(y, leaves)
    return plain_normed_sweep(csl_aug_apply(D, kinetic), t, dt, y, k1, tuple(leaves),
                              float(rtol), float(atol))


def csl_slot_order_sums(terms, slot_rows=CSL_SLOT_ROWS):
    """The sums over the batch of each of ``terms`` (each ``(B, A)``) in
    the order K7-CSL and K3-CSL take them (``csrc/csl_tsit5.cuh``
    ``csl_slot_sums``): per slot of ``slot_rows`` rows, element ``j`` of
    the slot's row-major elements is taken by thread ``j % 256``, which adds
    its elements in order of ``j``; a shuffle tree a warp; the warps added
    in order; then the slots, lane ``k % 32`` adding slot ``k`` in order of
    ``k``, and a shuffle tree (``sum_slots_warp_kernel``, ``sum_tiles``).
    Rows past the batch add zeros, which leave a sum of squares as it is.
    In float32 the sums equal the kernels' bitwise when the terms do."""
    from regneuralde_tpu_torch.ops.whole_solve import _warp_sum  # it imports this module

    out = []
    for x in terms:
        B, A = x.shape
        slots = -(-B // slot_rows)
        per = x.new_zeros(slots * slot_rows * A)
        per[:B * A] = x.reshape(-1)
        n = slot_rows * A
        laps = -(-n // _THREADS)
        lanes = x.new_zeros((slots, laps * _THREADS))
        lanes[:, :n] = per.reshape(slots, n)
        lanes = lanes.reshape(slots, laps, _THREADS)
        acc = x.new_zeros((slots, _THREADS))
        for lap in range(laps):
            acc = acc + lanes[:, lap]
        warps = _warp_sum(acc.reshape(slots, _THREADS // 32, 32))
        slot = x.new_zeros(slots)
        for w in range(_THREADS // 32):
            slot = slot + warps[:, w]
        strided = torch.cat([slot, slot.new_zeros(-slots % 32)]).reshape(-1, 32)
        lane_sums = x.new_zeros(32)
        for row in strided:
            lane_sums = lane_sums + row
        out.append(_warp_sum(lane_sums))
    return tuple(out)


def plain_csl_fwd_tiles(t, dt, y, k1, leaves, rtol, atol) -> NormedSweep:
    """K7-CSL in its own order of sums: the plain version's rows and
    per-element terms (``ode.normed_terms`` over ``csl_aug_apply``), the
    three sums taken as the kernel takes them (``csl_slot_order_sums``).
    For the tests: on the card the kernel's rows and sums equal these
    bitwise."""
    D, _, kinetic = csl_dims(y, leaves)
    y_new, k7, *terms = normed_terms(csl_aug_apply(D, kinetic), t, dt, y, k1, tuple(leaves),
                                     float(rtol), float(atol))
    return NormedSweep(y_new, k7, *csl_slot_order_sums(terms))


def _apply_bwd_rows(ti, z, acts, mz, eJ, ct_k, params, e, kinetic):
    """The pullback of one evaluation of the augmented dynamics from the
    cotangent ``ct_k`` of its output, row by row: ``(ct_z, layers)``, per
    layer ``(ct_o, ct_a, h, ug, c_out, a, uq, g)`` (each ``(rows, width)``
    but ``g``): weight ``l``'s cotangent is ``ct_a^T h + ug^T c_out``, its
    bias's ``sum ct_a``, the gate's and time bias's from ``ct_o``, ``a``,
    ``uq = u q`` and ``g``. The probe gets none."""
    D = e.shape[1]
    a1, g1, o1, a2, g2, o2, a3, g3, v3, v2 = acts
    W1, W2, W3 = params[0], params[5], params[10]
    ct_o3 = ct_k[:, :D]
    ct_eJ = -ct_k[:, D:D + 1] * e
    if kinetic:
        ct_o3 = ct_o3 + 2.0 * ct_k[:, D + 1:D + 2] * mz
        ct_eJ = ct_eJ + 2.0 * ct_k[:, D + 2:D + 3] * eJ
    s1, s2 = sigmoid(o1), sigmoid(o2)
    u1, u2 = v2 * s1, v3 * s2
    # the hops, last first: eJ = u1 (W1 g1), v2 = u2 (W2 g2), v3 = e (W3 g3);
    # q_l = ct_out W_l^T, so ct_u_l = g_l q_l and ct_g_l gets u_l q_l
    q1 = ct_eJ @ W1.T
    ct_v2 = g1 * q1 * s1
    ct_o1 = g1 * q1 * v2 * (s1 * (1.0 - s1))
    q2 = ct_v2 @ W2.T
    ct_v3 = g2 * q2 * s2
    ct_o2 = g2 * q2 * v3 * (s2 * (1.0 - s2))
    q3 = ct_v3 @ W3.T
    uq = [u1 * q1, u2 * q2, e * q3]
    ug = [u1 * g1, u2 * g2, e * g3]
    c_out = [ct_eJ, ct_v2, ct_v3]

    h = [z, softplus(o1), softplus(o2)]
    a, g, ct_o = [a1, a2, a3], [g1, g2, g3], [None, None, ct_o3]
    layers = [None] * 3
    for l in (2, 1, 0):
        if l == 1:
            ct_o[1] = ct_o2 + ct_x * s2
        elif l == 0:
            ct_o[0] = ct_o1 + ct_x * s1
        ct_a = ct_o[l] * g[l]
        layers[l] = (ct_o[l], ct_a, h[l], ug[l], c_out[l], a[l], uq[l], g[l])
        ct_x = ct_a @ params[5 * l]
    return ct_x, layers


def _batch_params(acc, ti, params, layers):
    """Adds one stage's parameter cotangents, summed over the batch, to
    ``acc`` (the parameters' order); returns the stage's ct_ti."""
    ct_ti = torch.zeros_like(ti)
    ct_p = [None] * N_PARAMS
    for l in (2, 1, 0):
        co, ct_a, h, ug, c_out, a, uq, g = layers[l]
        wg, wb = params[5 * l + 2], params[5 * l + 3]
        co_sum = co.sum(0)
        dg = (uq.sum(0) + (co * a).sum(0)) * (g * (1.0 - g))
        ct_ti = ct_ti + (co_sum * wb.reshape(-1)).sum() + (dg * wg.reshape(-1)).sum()
        ct_p[5 * l:5 * l + 5] = [ug.T @ c_out + ct_a.T @ h, ct_a.sum(0),
                                (dg * ti).reshape(wg.shape),
                                (co_sum * ti).reshape(wb.shape), co_sum]
    acc[:] = [x + d for x, d in zip(acc, ct_p)]
    return ct_ti


def _tile_params(acc, ti, params, layers):
    """``_batch_params`` in the order of K8-CSL's tile body
    (``csl_reverse_tile``): each weight element gets ``ct_a[r, o] h[r, k]``
    then ``ug[r, o] c_out[r, k]`` row after row; each output's vector sums
    (ct_o, ct_a, ct_o a + u q) run over the rows in order before they reach
    ``acc``."""
    ct_ti = torch.zeros_like(ti)
    for l in (0, 1, 2):
        co, ct_a, h, ug, c_out, a, uq, g = layers[l]
        iw, ib, ig, iwb, ibb = range(5 * l, 5 * l + 5)
        co_sum, ca_sum, cg = (torch.zeros_like(co[0]) for _ in range(3))
        for r in range(co.shape[0]):
            acc[iw] = acc[iw] + ct_a[r, :, None] * h[r, None, :]
            acc[iw] = acc[iw] + ug[r, :, None] * c_out[r, None, :]
            co_sum = co_sum + co[r]
            ca_sum = ca_sum + ct_a[r]
            cg = cg + (co[r] * a[r] + uq[r])
        dg = cg * (g * (1.0 - g))
        acc[ib] = acc[ib] + ca_sum
        acc[ig] = acc[ig] + (dg * ti).reshape(acc[ig].shape)
        acc[iwb] = acc[iwb] + (co_sum * ti).reshape(acc[iwb].shape)
        acc[ibb] = acc[ibb] + co_sum
        ct_ti = ct_ti + (co_sum * params[iwb].reshape(-1) + dg * params[ig].reshape(-1)).sum()
    return ct_ti


def _csl_reverse(t, dt, y, k1, leaves, cts, rtol, atol, add_params):
    """The hand reverse chain of the normed step: the stage recompute keeps
    each stage's activations, then the stages are walked in reverse, each
    through ``_apply_bwd_rows``, and ``add_params(acc, ti, params, layers)``
    adds the stage's parameter cotangents to ``acc`` and returns its ct_ti;
    stage ``i`` runs at ``t + c_i dt``, so its time cotangent reaches both
    ``t`` and ``dt``. Returns ``(ct_t, ct_dt, ct_y, ct_k1, ct_leaves)``."""
    tab = TSIT5
    leaves = tuple(leaves)
    params, e = leaves[:N_PARAMS], leaves[N_PARAMS]
    D, _, kinetic = csl_dims(y, leaves)
    cyn, ck7, c_err, c_num, c_den = cts

    ks, recs = [k1], []
    for i in range(1, 7):
        ti = t + tab.c[i] * dt
        z = (y + dt * _stage_acc(i, ks))[:, :D]
        mz, eJ, acts = _csl_forward(ti, z, params, e)
        ks.append(aug_out(mz, eJ, e, kinetic))
        recs.append((ti, z, acts, mz, eJ))
    y_new = y + dt * _stage_acc(6, ks)
    g6 = y + dt * _stage_acc(5, ks)

    s_comb = tab.btilde[1] * (ks[1] - ks[0])
    for c, k in zip(tab.btilde[2:], ks[2:]):
        s_comb = s_comb + c * (k - ks[0])
    err = dt * s_comb
    ay, an = torch.abs(y), torch.abs(y_new)
    denom = atol + torch.maximum(ay, an) * rtol
    scaled = err / denom
    cerr = c_err * 2.0 * scaled / denom
    cm = c_err * (-2.0) * scaled * scaled / denom * rtol
    to_y = _max_grad(ay, an, cm) * torch.sign(y)
    to_ynew = _max_grad(an, ay, cm) * torch.sign(y_new)
    d_k7 = c_num * 2.0 * (ks[6] - ks[5])
    d_ynew = c_den * 2.0 * (y_new - g6)

    ct_ks = [tab.btilde[j] * (dt * cerr) for j in range(7)]
    ct_ks[6] = ct_ks[6] + ck7 + d_k7
    ct_ks[5] = ct_ks[5] - d_k7
    seeds = {6: cyn + d_ynew + to_ynew, 5: -d_ynew}

    ct_dt = torch.sum(cerr * s_comb)
    ct_t = torch.zeros_like(ct_dt)
    ct_y = to_y
    ct_params = [torch.zeros_like(x) for x in params]
    for i in range(6, 0, -1):
        ti, z, acts, mz, eJ = recs[i - 1]
        ct_z, layers = _apply_bwd_rows(ti, z, acts, mz, eJ, ct_ks[i], params, e, kinetic)
        ct_ti = add_params(ct_params, ti, params, layers)
        ct_yi = torch.cat([ct_z, torch.zeros_like(y[:, D:])], dim=-1)
        if i in seeds:
            ct_yi = ct_yi + seeds[i]
        ct_y = ct_y + ct_yi
        ct_t = ct_t + ct_ti
        ct_dt = ct_dt + torch.sum(ct_yi * _stage_acc(i, ks)) + tab.c[i] * ct_ti
        for j, c in enumerate(tab.a[i - 1]):
            if c != 0.0:
                ct_ks[j] = ct_ks[j] + (dt * c) * ct_yi
    return ct_t, ct_dt, ct_y, ct_ks[0], (*ct_params, torch.zeros_like(e))


def _csl_bwd_math(t, dt, y, k1, leaves, cts, rtol, atol):
    """Plain version of K8-CSL: the hand reverse chain of the normed step
    (``_csl_reverse``), each stage's parameter cotangents summed over the
    batch.

    Maps ``cts = (ct_y_new, ct_k7, ct_err_ssq, ct_num_ssq, ct_den_ssq)`` to
    ``(ct_t, ct_dt, ct_y, ct_k1, ct_leaves)``, the probe's cotangent zero.
    The kernel's chain (``csrc/csl_tsit5.cuh`` ``csl_reverse_tile``) in
    its order of sums is ``plain_csl_bwd_tiles``."""
    return _csl_reverse(t, dt, y, k1, leaves, cts, rtol, atol, _batch_params)


def plain_csl_bwd_tiles(t, dt, y, k1, leaves, cts, rtol, atol, rows=None):
    """``_csl_bwd_math`` with the parameter cotangents and ``(ct_t, ct_dt)``
    summed in K8-CSL's order: per tile of ``rows`` rows (the kernel's,
    ``CSL_BWD_ROWS``, by default) the chain on the tile's rows, its stages
    6 to 1 each adding the tile's rows in order (``_tile_params``), then
    the tiles' sums in tile order (the slot sum). ct_y and ct_k1 are per
    row. For the tests: the CPU path of ``csl_normed_sweep_bwd`` is
    ``_csl_bwd_math``."""
    rows = CSL_BWD_ROWS if rows is None else rows
    leaves = tuple(leaves)
    cyn, ck7, *scalars = cts
    out, ct_y, ct_k1 = None, [], []
    for r0 in range(0, y.shape[0], rows):
        tile = slice(r0, r0 + rows)
        ct_t, ct_dt, cy, ck, ct_leaves = _csl_reverse(
            t, dt, y[tile], k1[tile], (*leaves[:N_PARAMS], leaves[N_PARAMS][tile]),
            (cyn[tile], ck7[tile], *scalars), rtol, atol, _tile_params)
        sums = (ct_t, ct_dt, *ct_leaves[:N_PARAMS])
        out = sums if out is None else tuple(a + b for a, b in zip(out, sums))
        ct_y.append(cy)
        ct_k1.append(ck)
    return (out[0], out[1], torch.cat(ct_y), torch.cat(ct_k1),
            (*out[2:], torch.zeros_like(leaves[N_PARAMS])))


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, kernel for CUDA tensors.
# ---------------------------------------------------------------------------


def _check_cuda_args(y, k1, leaves, extra=()):
    """``(B, A, H, kinetic)`` after checking the rows and leaves (device,
    float32, shape, contiguity); ``A`` is the augmented state's width."""
    if y.dim() != 2:
        raise ValueError(f"y must be (batch, dim), got {tuple(y.shape)}")
    B, A = y.shape
    D, H, kinetic = csl_dims(y, leaves)
    want = {"k1": (k1, (B, A))}
    for l, (n_in, n_out) in enumerate(((D, H), (H, H), (H, D))):
        shapes = ((n_out, n_in), (n_out,), (n_out, 1), (n_out, 1), (n_out,))
        for name, x, shape in zip(LEAF_NAMES[5 * l:5 * l + 5], leaves[5 * l:5 * l + 5],
                                  shapes):
            want[name] = (x, shape)
    want["e"] = (leaves[N_PARAMS], (B, D))
    want.update(extra)
    for name, (x, shape) in {"y": (y, (B, A)), **want}.items():
        if x.device != y.device:
            raise ValueError(f"{name} is on {x.device}, y on {y.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, A, H, int(kinetic)


def _pad4(n):
    return (n + 3) // 4 * 4


class CslFwdPlan(NamedTuple):
    """The forward tile body at a batch and widths: ``rows`` a tile,
    ``slot_rows`` a norm-sum slot, ``tiles`` (K7-CSL's blocks, K3-CSL's
    grid where the card holds them), ``slots`` and ``smem_bytes`` a
    block."""
    rows: int
    slot_rows: int
    tiles: int
    slots: int
    smem_bytes: int


def csl_fwd_plan(B, D, H, kinetic) -> CslFwdPlan:
    """``csrc/csl_tsit5.cuh``'s sizes of the forward body
    (``csl_forward_floats``, ``csl_fwd_smem_bytes``) at ``B x D x H``;
    raises ``ValueError`` for layers whose parameters and tile need more
    shared memory than ``SMEM_LIMIT``."""
    R, S, A = CSL_FWD_ROWS, CSL_SLOT_ROWS, D + (3 if kinetic else 1)
    n, pd, ph = R * A, R * _pad4(D), R * _pad4(H)
    parts = ([n, 7 * n, n, n, pd, 2 * pd, 2 * H + D] + [2 * max(pd, ph)] * 2
             + [ph, ph, pd, 3 * (R // S) * (_THREADS // 32)])
    params = sum(o * (i + 5) for i, o in ((D, H), (H, H), (H, D)))
    smem = 4 * (params + 4 + sum(_pad4(x) for x in parts))
    if smem > SMEM_LIMIT:
        raise ValueError(f"K7-CSL's tile body holds at most {SMEM_LIMIT} bytes of shared "
                         f"memory; dim {D}, hidden {H} need {smem}")
    return CslFwdPlan(R, S, -(-B // R), -(-B // S), smem)


@functools.lru_cache(maxsize=16)
def check_fwd_plan(lib, A, D, H, kinetic) -> CslFwdPlan:
    """``csl_fwd_plan`` held to the library's constants (once a shape)."""
    plan = csl_fwd_plan(0, D, H, kinetic)
    if (lib.regnde_csl_rows() != CSL_FWD_ROWS
            or lib.regnde_csl_slot_rows() != CSL_SLOT_ROWS
            or lib.regnde_csl_fwd_smem_bytes(A, D, H) != plan.smem_bytes):
        raise RuntimeError("csl_fwd_plan disagrees with csrc/csl_tsit5.cuh's sizes")
    return plan


def _cuda_csl_fwd(t, dt, y, k1, leaves, rtol, atol):
    from regneuralde_tpu_torch.ops import _cuda

    B, A, H, kinetic = _check_cuda_args(y, k1, leaves)
    D = A - 1 - 2 * kinetic
    plan = csl_fwd_plan(B, D, H, kinetic)
    lib = _cuda.library()
    check_fwd_plan(lib, A, D, H, kinetic)
    t32, dt32 = _scalar_f32(t, y), _scalar_f32(dt, y)
    y_new = torch.empty_like(y)
    k7 = torch.empty_like(y)
    partials = torch.empty((plan.slots, 3), device=y.device)
    sums = torch.empty(3, device=y.device)
    ptrs = _leaf_pointers(leaves)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    code = lib.regnde_csl_fwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), ctypes.cast(ptrs, ctypes.c_void_p),
        kinetic, _ptr(y_new), _ptr(k7), _ptr(partials), _ptr(sums), B, A, H,
        float(rtol), float(atol), ctypes.c_void_p(stream))
    _cuda.check(code, "CSL Tsit5 forward kernel")
    LAUNCHES["csl_tsit5_fwd"] += 1
    return NormedSweep(y_new, k7, sums[0], sums[1], sums[2])


def _unpack_cts(out, leaves):
    """The 15 parameters' cotangents from the kernels' flat output, and the
    probe's (zeros)."""
    ct, off = [], 0
    for x in leaves[:N_PARAMS]:
        ct.append(out[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return (*ct, torch.zeros_like(leaves[N_PARAMS]))


class CslBwdPlan(NamedTuple):
    """The reverse tile body at a batch and widths: ``rows`` a tile,
    ``tiles`` (K8-CSL's blocks), ``cw_tiles`` (4 x 4 weight-cotangent
    tiles over the three weights), ``smem_bytes`` a block, and
    ``record_floats`` of activation records a block in device memory."""
    rows: int
    tiles: int
    cw_tiles: int
    smem_bytes: int
    record_floats: int


def csl_bwd_plan(B, D, H, kinetic) -> CslBwdPlan:
    """``csrc/csl_tsit5.cuh``'s sizes of the reverse body (``csl_reverse_
    floats``, ``csl_bwd_smem_bytes``, ``csl_cw_tiles``) at ``B x D x H``;
    raises ``ValueError`` for layers it does not hold (more weight tiles
    than ``CSL_BWD_MAX_TILES`` or more shared memory than ``SMEM_LIMIT``)."""
    R, A = CSL_BWD_ROWS, D + (3 if kinetic else 1)
    dims = ((D, H), (H, H), (H, D))  # (in, out) by layer
    rec_row = 6 * H + 2 * D
    n, pd, ph = R * A, R * _pad4(D), R * _pad4(H)
    parts = ([n, 7 * n, 7 * n, n, n, n, n, pd, 2 * pd, 2 * H + D, 4 * (2 * H + D), R * rec_row]
             + [2 * max(pd, ph)] * 2 + [pd] * 7 + [ph] * 12 + [16])
    params = sum(o * (i + 5) for i, o in dims)
    smem = 4 * (params + 4 + sum(_pad4(x) for x in parts))
    cw = sum(((o + 3) // 4) * ((i + 3) // 4) for i, o in dims)
    if cw > CSL_BWD_MAX_TILES or smem > SMEM_LIMIT:
        raise ValueError(
            f"K8-CSL's tile body holds at most {CSL_BWD_MAX_TILES} weight tiles and "
            f"{SMEM_LIMIT} bytes of shared memory; dim {D}, hidden {H} need {cw} and {smem}")
    return CslBwdPlan(R, (B + R - 1) // R, cw, smem, 6 * R * rec_row)


@functools.lru_cache(maxsize=16)
def check_bwd_plan(lib, A, D, H, kinetic) -> CslBwdPlan:
    """``csl_bwd_plan`` held to the library's constants (once a shape)."""
    plan = csl_bwd_plan(0, D, H, kinetic)
    if (lib.regnde_csl_bwd_rows() != CSL_BWD_ROWS
            or lib.regnde_csl_bwd_max_tiles() != CSL_BWD_MAX_TILES
            or lib.regnde_csl_bwd_smem_bytes(A, D, H) != plan.smem_bytes):
        raise RuntimeError("csl_bwd_plan disagrees with csrc/csl_tsit5.cuh's sizes")
    return plan


@functools.lru_cache(maxsize=8)
def _csl_bwd_scratch(lib, B, A, D, H, kinetic, dev, stream):
    """K8-CSL's scratch at ``B x A x H`` on ``stream``: the per-tile slots
    (parameter cotangents, then ct_t and ct_dt) and activation records.
    Nothing of it outlives a launch, and launches on one stream run in
    order, so it is made once and reused."""
    plan = check_bwd_plan(lib, A, D, H, kinetic)
    n_leaf = D * H + H * H + H * D + 4 * (2 * H + D)
    tiles = (B + plan.rows - 1) // plan.rows
    return (torch.empty((tiles, n_leaf + 2), device=dev),
            torch.empty((tiles, plan.record_floats), device=dev))


def _cuda_csl_bwd(t, dt, y, k1, leaves, cts, rtol, atol):
    from regneuralde_tpu_torch.ops import _cuda

    cyn, ck7 = cts[0], cts[1]
    B, A, H, kinetic = _check_cuda_args(
        y, k1, leaves, {"ct_y_new": (cyn, tuple(y.shape)), "ct_k7": (ck7, tuple(y.shape))})
    D = A - 1 - 2 * kinetic
    csl_bwd_plan(B, D, H, kinetic)
    lib = _cuda.library()
    t32, dt32 = _scalar_f32(t, y), _scalar_f32(dt, y)
    ct_scalars = torch.stack([_scalar_f32(c, y) for c in cts[2:]]).contiguous()
    dev = y.device
    ct_y = torch.empty_like(y)
    ct_k1 = torch.empty_like(y)
    n_leaf = sum(x.numel() for x in leaves[:N_PARAMS])
    out = torch.empty(n_leaf + 2, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    slots, recs = _csl_bwd_scratch(lib, B, A, D, H, kinetic, dev, stream)
    ptrs = _leaf_pointers(leaves)
    code = lib.regnde_csl_bwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), ctypes.cast(ptrs, ctypes.c_void_p),
        kinetic, _ptr(cyn), _ptr(ck7), _ptr(ct_scalars), _ptr(ct_y), _ptr(ct_k1),
        _ptr(slots), _ptr(recs), _ptr(out), B, A, H, float(rtol), float(atol),
        ctypes.c_void_p(stream))
    _cuda.check(code, "CSL Tsit5 backward kernel")
    LAUNCHES["csl_tsit5_bwd"] += 1
    return out[n_leaf], out[n_leaf + 1], ct_y, ct_k1, _unpack_cts(out, leaves)


def csl_normed_sweep(t, dt, y, k1, leaves: Sequence[torch.Tensor], rtol, atol
                     ) -> NormedSweep:
    """K7-CSL or its plain version: ``(y_new, k7, err_ssq, num_ssq, den_ssq)``."""
    if y.device.type == "cuda":
        return _cuda_csl_fwd(t, dt, y, k1, tuple(leaves), rtol, atol)
    if y.device.type == "cpu":
        return plain_csl_normed_sweep(t, dt, y, k1, leaves, rtol, atol)
    raise RuntimeError(f"no CSL Tsit5 forward for device {y.device}")


def csl_normed_sweep_bwd(t, dt, y, k1, leaves: Sequence[torch.Tensor], cts, rtol, atol
                         ) -> Tuple:
    """K8-CSL or its plain version: ``(ct_t, ct_dt, ct_y, ct_k1, ct_leaves)``."""
    if y.device.type == "cuda":
        return _cuda_csl_bwd(t, dt, y, k1, tuple(leaves), tuple(cts), rtol, atol)
    if y.device.type == "cpu":
        return _csl_bwd_math(t, dt, y, k1, tuple(leaves), tuple(cts), float(rtol),
                             float(atol))
    raise RuntimeError(f"no CSL Tsit5 backward for device {y.device}")


class CslNormedSweepFn(torch.autograd.Function):
    """The normed trial step with the hand backward as its gradient."""

    @staticmethod
    def forward(ctx, t, dt, y, k1, rtol, atol, *leaves):
        ctx.save_for_backward(t, dt, y, k1, *leaves)
        ctx.tols = (rtol, atol)
        return tuple(csl_normed_sweep(t, dt, y, k1, leaves, rtol, atol))

    @staticmethod
    def backward(ctx, cyn, ck7, ce, cn, cd):
        t, dt, y, k1, *leaves = ctx.saved_tensors
        scalar0 = y.new_zeros(())
        cts = (torch.zeros_like(y) if cyn is None else cyn.contiguous(),
               torch.zeros_like(y) if ck7 is None else ck7.contiguous(),
               *(scalar0 if c is None else c for c in (ce, cn, cd)))
        ct_t, ct_dt, ct_y, ct_k1, ct_leaves = csl_normed_sweep_bwd(
            t, dt, y, k1, leaves, cts, *ctx.tols)
        return (ct_t.to(t.dtype).reshape(t.shape), ct_dt.to(dt.dtype).reshape(dt.shape),
                ct_y, ct_k1, None, None, *ct_leaves)


def make_csl_ffjord_sweep(rtol: float, atol: float):
    """The fused trial-step pair ``(sweep, sweep_bwd)`` for
    ``FFJORD(CSLDynamics(...), fused="step")`` over the CSL leaves and the
    probe: the forward differentiable through ``CslNormedSweepFn``, the
    backward one K8-CSL launch (or its plain version) for the fast adjoint,
    with no forward replay."""
    rtol, atol = float(rtol), float(atol)

    def sweep(t, dt, y, k1, leaves):
        t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
        dt = torch.as_tensor(dt, dtype=y.dtype, device=y.device)
        return NormedSweep(*CslNormedSweepFn.apply(t, dt, y, k1, rtol, atol, *leaves))

    def sweep_bwd(t, dt, y, k1, leaves, cts):
        return csl_normed_sweep_bwd(t, dt, y, k1, tuple(leaves), tuple(cts), rtol, atol)

    return sweep, sweep_bwd


def make_plain_csl_sweep(rtol: float, atol: float):
    """The plain versions of K7/K8-CSL on any device, as ``(sweep,
    sweep_bwd)``: the path of ``FFJORD(fused=False)``, the same trial-step
    algebra with no kernel."""
    rtol, atol = float(rtol), float(atol)

    def sweep(t, dt, y, k1, leaves):
        return plain_csl_normed_sweep(t, dt, y, k1, leaves, rtol, atol)

    def sweep_bwd(t, dt, y, k1, leaves, cts):
        return _csl_bwd_math(t, dt, y, k1, tuple(leaves), tuple(cts), rtol, atol)

    return sweep, sweep_bwd
