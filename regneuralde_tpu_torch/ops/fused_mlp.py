"""Tsit5 trial step of ``MLPDynamics``: plain PyTorch and CUDA kernels.

Counterpart of ``regneuralde_tpu/ops/pallas_mlp.py``'s scalar-time steps.
One trial step runs the six Tsit5 stages of ``MLPDynamics``, in either of
the solver's two sweep protocols (``ops.ode``):

* the tuple step (K13/K14) returns the rows ``(y_new, k7, err, k6, g6)``:
  the new state, the last stage derivative (FSAL), the embedded error
  ``err = dt * sum_i btilde_i (k_i - k1)``, the stage-6 derivative and the
  stage-5 state, from which the solver takes the error and stiffness norms;
* the normed step (K1/K2) reduces those norms to three sums of squares in
  the kernel, so only ``(y_new, k7, err_ssq, num_ssq, den_ssq)`` leave it:
  ``err_ssq = sum((err / (atol + max(|y|, |y_new|) * rtol))^2)``,
  ``num_ssq = sum((k7 - k6)^2)`` and ``den_ssq = sum((y_new - g6)^2)``.

The weights are the four leaves ``(W1, b1, W2, b2)`` of the two
``nn.Linear`` layers of ``models.basic.MLPDynamics``: ``W1`` is
``(H, D+1)`` and ``W2`` is ``(D, H+1)``, the time column last.

Each step has a plain version (``_reference_sweep`` and ``_bwd_math``, the
hand reverse chain of ``pallas_mlp._fused_bwd_kernel``;
``_reference_normed_sweep`` and ``_normed_bwd_math``, that of
``pallas_mlp._normed_bwd_math``) and a CUDA kernel pair. K13 and K1 are
one kernel, ``csrc/mlp_step_solve.cuh``, one trial step of the whole
solve's forward stages on its tile plan, with the tuple's rows or the
normed step's rows and norm sums at its end; their backwards K14 and K2
are one kernel, ``csrc/mlp_step_walk.cuh``, one trial step of the whole
solve's reverse walk on the same plan, with the tuple's or the normed
step's seeds. The wrappers
``stage_sweep_fwd``/``stage_sweep_bwd`` and ``normed_sweep_fwd``/
``normed_sweep_bwd`` take the plain version for tensors on the CPU, launch
the kernel for tensors on a CUDA device, and raise otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from regneuralde_tpu_torch.ops import weight_cotangents as wc
from regneuralde_tpu_torch.ops.math import tanh as _tanh
from regneuralde_tpu_torch.ops.tableaus import TSIT5

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"normed_tsit5_fwd": 0, "normed_tsit5_bwd": 0, "mlp_tsit5_fwd": 0,
            "mlp_tsit5_bwd": 0}


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


def _recompute(t, dt, y, k1, parts):
    """The six stages again: the derivatives ``ks`` (k1 first) and each
    stage's hidden activations ``hs``."""
    ks, hs = [k1], []
    for i in range(1, 7):
        yi = y + dt * _stage_acc(i, ks)
        k, h = _mlp_k(yi, t + TSIT5.c[i] * dt, parts)
        ks.append(k)
        hs.append(h)
    return ks, hs


def _reference_normed_sweep_res(t, dt, y, k1, parts, rtol, atol):
    """The normed trial step with its stage residuals
    (``pallas_mlp.make_normed_algebra_fwd_res``): ``(outs, (ks, hs))``,
    ``outs`` bitwise ``_reference_normed_sweep``'s quintuple and ``(ks,
    hs)`` bitwise ``_recompute``'s, so ``_normed_bwd_math(res=)`` given
    them equals the call that recomputes them."""
    ks, hs = _recompute(t, dt, y, k1, parts)
    return _normed_outs(dt, y, ks, rtol, atol), (ks, hs)


def _normed_outs(dt, y, ks, rtol, atol):
    """The normed quintuple ``(y_new, k7, err_ssq, num_ssq, den_ssq)`` of a
    trial step from its stage derivatives ``ks`` (k1 first)."""
    y_new = y + dt * _stage_acc(6, ks)
    g6 = y + dt * _stage_acc(5, ks)
    err = dt * _err_comb(ks)
    denom = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
    scaled = err / denom
    dk = ks[6] - ks[5]
    dg = y_new - g6
    return (y_new, ks[6], torch.sum(scaled * scaled), torch.sum(dk * dk),
            torch.sum(dg * dg))


def _err_comb(ks):
    """``sum_{j>=1} btilde_j (k_j - k1)``, the embedded error over dt."""
    s_comb = TSIT5.btilde[1] * (ks[1] - ks[0])
    for c, k in zip(TSIT5.btilde[2:], ks[2:]):
        s_comb = s_comb + c * (k - ks[0])
    return s_comb


def _reverse_stages(t, dt, y, parts, ks, hs, ct_ks, seeds, ct_dt, ct_y, rows=None):
    """The reverse chain over the six stages, shared by K2's and K14's
    plain versions: from the stage derivatives' cotangents ``ct_ks`` and
    the stage inputs' seeds ``seeds`` (stage index -> rows) to ``(ct_t,
    ct_dt, ct_y, ct_k1, (cW1, cb1, cW2, cb2))``; ``ct_dt`` and ``ct_y``
    come in with the seeds' own shares. A list ``rows`` gets, stage by
    stage from 6 down, ``(i, ct_pre2, h_i, ct_pre1, y_i, t_i)``: what the
    kernels store for the weight-cotangent contraction
    (``ops.weight_cotangents``)."""
    tab = TSIT5
    w1x, w1t, b1, w2h, w2t, b2 = parts
    ct_t = torch.zeros_like(ct_dt)
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
        if rows is not None:
            rows.append((i, ct_pre2, h_i, ct_pre1, yi, ti))
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


def _bwd_math(t, dt, y, k1, parts, cts):
    """Plain version of K14: the hand reverse chain of the tuple step
    (``pallas_mlp._fused_bwd_kernel``).

    Maps the row cotangents ``cts = (ct_y_new, ct_k7, ct_err, ct_k6,
    ct_g6)`` to ``(ct_t, ct_dt, ct_y, ct_k1, (cW1, cb1, cW2, cb2))``.
    ``err = dt * sum_j btilde_j (k_j - k1)`` seeds ``btilde_j * dt *
    ct_err`` into every stage derivative (the k1 terms cancel, as
    ``sum(btilde) == 0``) and ``sum(ct_err * err / dt)`` into ``ct_dt``;
    ``ct_g6`` seeds stage 5's input, ``ct_y_new`` stage 6's."""
    cyn, ck7, cerr, ck6, cg6 = cts
    ks, hs = _recompute(t, dt, y, k1, parts)
    ct_ks = [TSIT5.btilde[j] * (dt * cerr) for j in range(7)]
    ct_ks[6] = ct_ks[6] + ck7
    ct_ks[5] = ct_ks[5] + ck6
    return _reverse_stages(t, dt, y, parts, ks, hs, ct_ks, {6: cyn, 5: cg6},
                           torch.sum(cerr * _err_comb(ks)), torch.zeros_like(y))


def _normed_bwd_math(t, dt, y, k1, parts, cts, rtol, atol, res=None, rows=None):
    """Plain version of K2: the hand reverse chain of the normed step.

    Maps ``cts = (ct_y_new, ct_k7, ct_err_ssq, ct_num_ssq, ct_den_ssq)``
    to ``(ct_t, ct_dt, ct_y, ct_k1, (cW1, cb1, cW2, cb2))``. All of the
    ``max(|y|, |y_new|)`` subgradient goes to ``y`` on ties, as in
    ``pallas_mlp._normed_bwd_math``; ``torch.autograd`` of the plain
    forward would split it. ``res``, when given, is ``(ks, hs)`` from
    ``_reference_normed_sweep_res`` on the same inputs (``ks`` k1 first):
    the stages are then not recomputed. ``rows``: as ``_reverse_stages``'."""
    tab = TSIT5
    cyn, ck7, ct_errssq, ct_numssq, ct_denssq = cts
    if res is None:
        ks, hs = _recompute(t, dt, y, k1, parts)
    else:
        ks, hs = list(res[0]), list(res[1])
    y_new = y + dt * _stage_acc(6, ks)

    s_comb = _err_comb(ks)
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
    return _reverse_stages(t, dt, y, parts, ks, hs, ct_ks, seeds,
                           torch.sum(cerr * s_comb), to_y, rows)


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


@functools.lru_cache(maxsize=8)
def _step_walk_scratch(lib, plan, B, D, H, dev, lanes, stream):
    """The scratch of K2, K14 and, with ``lanes``, K12 at ``B x D x H`` on
    ``plan`` and ``stream``: ``(tensors, sizes)``, the slots, the walk's and
    the replay's scratch, the weight-cotangent rows and the contraction's
    scratch, and the ints from B on. Nothing of it outlives a launch, and
    launches on one stream run in order, so it is made once and reused:
    what a launch allocates is its outputs."""
    from regneuralde_tpu_torch.ops import whole_solve as ws

    if lanes:
        slots = torch.empty((plan.chunks * plan.row_blocks * plan.rows, plan.col_blocks),
                            device=dev)
    else:
        slots = torch.empty((plan.tiles, 2), device=dev)
    walk, step = ws._cuda_walk_scratch(lib, plan, B, D, H, dev, replay=True)
    rows = (torch.empty((6 * B, D), device=dev), torch.empty((6 * B, H + 2), device=dev),
            torch.empty((6 * B, H), device=dev), torch.empty((6 * B, D + 2), device=dev))
    wpart, chunk_rows, wfloats = wc.cuda_scratch(6 * B, D, H, dev)
    sizes = (B, D, H, plan.rows, plan.cols, plan.row_blocks, plan.col_blocks, plan.chunks,
             chunk_rows, wfloats)
    return (slots, *walk, *step, *rows, wpart), sizes


def _step_walk_buffers(lib, y, leaves, lanes=False):
    """The outputs and scratch of K2, K14 and, with ``lanes``, K12
    (``csrc/mlp_step_walk.cuh``), one trial step of the whole solve's walk on
    its tile plan (``whole_solve.walk_plan``): ``(outs, bufs, sizes)``,
    ``outs = (ct_t, ct_dt, ct_y, ct_k1, (cW1, cb1, cW2, cb2))``, and the C
    entries' shared arguments from ``ct_y`` on: the tensors ``bufs`` (the
    outputs, then ``_step_walk_scratch``'s) and the ints ``sizes`` (B, D,
    H, the plan, the contraction's chunks). K12's ``ct_t`` and ``ct_dt``
    are ``(B,)`` and its slots one a (row, column block)."""
    from regneuralde_tpu_torch.ops import whole_solve as ws

    (B, D), dev = y.shape, y.device
    H = leaves[0].shape[0]
    plan = ws._cuda_walk_plan(lib, B, D, H, dev, lanes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, sizes = _step_walk_scratch(lib, plan, B, D, H, dev, lanes, stream)
    ct_y, ct_k1 = torch.empty_like(y), torch.empty_like(y)
    ct_leaves = tuple(torch.empty_like(x) for x in leaves)
    ct_tdt = torch.empty((2, B) if lanes else 2, device=dev)
    bufs = (ct_y, ct_k1, *ct_leaves, ct_tdt, *scratch)
    return (ct_tdt[0], ct_tdt[1], ct_y, ct_k1, ct_leaves), bufs, sizes


def _cuda_normed_bwd(t, dt, y, k1, leaves, cts, rtol, atol):
    """K2: one cooperative launch of ``csrc/mlp_step_walk.cuh`` with the
    normed step's seeds on the whole solve's tile plan, then the
    weight-cotangent contraction. The norm sums' cotangents reach the
    kernel as a device array: no host sync."""
    from regneuralde_tpu_torch.ops import _cuda

    cyn, ck7 = cts[0], cts[1]
    _check_cuda_args(y, k1, leaves, {"ct_y_new": (cyn, tuple(y.shape)),
                                     "ct_k7": (ck7, tuple(y.shape))})
    lib = _cuda.library()
    t32, dt32 = _scalar_f32(t, y), _scalar_f32(dt, y)
    ct_norms = torch.stack([_scalar_f32(c, y) for c in cts[2:]])
    outs, bufs, sizes = _step_walk_buffers(lib, y, leaves)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    code = lib.regnde_normed_bwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), *map(_ptr, leaves), _ptr(cyn), _ptr(ck7),
        _ptr(ct_norms), *map(_ptr, bufs), *sizes, float(rtol), float(atol),
        ctypes.c_void_p(stream))
    _cuda.check(code, "normed Tsit5 backward kernel")
    LAUNCHES["normed_tsit5_bwd"] += 1
    wc.count_launch()
    return outs


@functools.lru_cache(maxsize=8)
def _step_solve_scratch(lib, plan, H, dev, stream, lanes=False):
    """The scratch of K13 and K1 on ``plan`` and ``stream``: K3's (partials,
    hidden rows, padded weights, slots); with ``lanes`` K11's, the same in
    doubles. Made once and reused, as ``_step_walk_scratch``: what a launch
    allocates is its outputs."""
    from regneuralde_tpu_torch.ops import whole_solve as ws

    return ws._cuda_solve_scratch(lib, plan, H, dev, lanes)


def _cuda_normed_fwd(t, dt, y, k1, leaves, rtol, atol):
    """K1: one cooperative launch of ``csrc/mlp_step_solve.cuh`` with the
    normed end, K3's six stages on the whole solve's tile plan, then each
    tile's y_new and k7 rows and its norm sums, summed over the tiles in
    tile order in the same launch. t and dt stay on the device: no host
    sync."""
    from regneuralde_tpu_torch.ops import _cuda
    from regneuralde_tpu_torch.ops import whole_solve as ws

    B, D, H = _check_cuda_args(y, k1, leaves)
    t32, dt32 = _scalar_f32(t, y), _scalar_f32(dt, y)
    lib = _cuda.library()
    plan = ws._cuda_walk_plan(lib, B, D, H, y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    scratch = _step_solve_scratch(lib, plan, H, y.device, stream)
    y_new, k7 = torch.empty_like(y), torch.empty_like(y)
    sums = torch.empty(3, device=y.device)
    code = lib.regnde_normed_fwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), *map(_ptr, leaves), _ptr(y_new), _ptr(k7),
        _ptr(sums), _ptr(scratch), B, D, H, plan.rows, plan.cols, plan.row_blocks,
        plan.col_blocks, plan.chunks, float(rtol), float(atol), ctypes.c_void_p(stream))
    _cuda.check(code, "normed Tsit5 forward kernel")
    LAUNCHES["normed_tsit5_fwd"] += 1
    return y_new, k7, sums[0], sums[1], sums[2]


def _cuda_fwd(t, dt, y, k1, leaves):
    """K13: one cooperative launch of ``csrc/mlp_step_solve.cuh``, K3's six
    stages on the whole solve's tile plan, then each tile's five rows."""
    from regneuralde_tpu_torch.ops import _cuda
    from regneuralde_tpu_torch.ops import whole_solve as ws

    B, D, H = _check_cuda_args(y, k1, leaves)
    t32, dt32 = _scalar_f32(t, y), _scalar_f32(dt, y)
    lib = _cuda.library()
    plan = ws._cuda_walk_plan(lib, B, D, H, y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    scratch = _step_solve_scratch(lib, plan, H, y.device, stream)
    outs = [torch.empty_like(y) for _ in range(5)]
    code = lib.regnde_mlp_tsit5_fwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), *map(_ptr, leaves), *map(_ptr, outs),
        _ptr(scratch), B, D, H, plan.rows, plan.cols, plan.row_blocks, plan.col_blocks,
        plan.chunks, ctypes.c_void_p(stream))
    _cuda.check(code, "Tsit5 forward kernel")
    LAUNCHES["mlp_tsit5_fwd"] += 1
    return tuple(outs)


def _cuda_bwd(t, dt, y, k1, leaves, cts):
    """K14: one cooperative launch of ``csrc/mlp_step_walk.cuh`` with the
    tuple's five row seeds on the whole solve's tile plan, then the
    weight-cotangent contraction."""
    from regneuralde_tpu_torch.ops import _cuda

    names = ("ct_y_new", "ct_k7", "ct_err", "ct_k6", "ct_g6")
    _check_cuda_args(y, k1, leaves, {n: (c, tuple(y.shape)) for n, c in zip(names, cts)})
    lib = _cuda.library()
    t32, dt32 = _scalar_f32(t, y), _scalar_f32(dt, y)
    outs, bufs, sizes = _step_walk_buffers(lib, y, leaves)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    code = lib.regnde_mlp_tsit5_bwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), *map(_ptr, leaves), *map(_ptr, cts),
        *map(_ptr, bufs), *sizes, ctypes.c_void_p(stream))
    _cuda.check(code, "Tsit5 backward kernel")
    LAUNCHES["mlp_tsit5_bwd"] += 1
    wc.count_launch()
    return outs


def stage_sweep_fwd(t, dt, y, k1, leaves: Sequence[torch.Tensor]):
    """K13 or its plain version: ``(y_new, k7, err, k6, g6)``."""
    if y.device.type == "cuda":
        return _cuda_fwd(t, dt, y, k1, tuple(leaves))
    if y.device.type == "cpu":
        return _reference_sweep(t, dt, y, k1, _split_params(*leaves))
    raise RuntimeError(f"no Tsit5 forward for device {y.device}")


def stage_sweep_bwd(t, dt, y, k1, leaves: Sequence[torch.Tensor], cts):
    """K14 or its plain version: ``(ct_t, ct_dt, ct_y, ct_k1, ct_leaves)``
    from the five row cotangents."""
    if y.device.type == "cuda":
        return _cuda_bwd(t, dt, y, k1, tuple(leaves), tuple(cts))
    if y.device.type == "cpu":
        return _bwd_math(t, dt, y, k1, _split_params(*leaves), tuple(cts))
    raise RuntimeError(f"no Tsit5 backward for device {y.device}")


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


class StageSweepFn(torch.autograd.Function):
    """The tuple trial step, K13 forward and K14 backward (their plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, t, dt, y, k1, W1, b1, W2, b2):
        ctx.save_for_backward(t, dt, y, k1, W1, b1, W2, b2)
        return stage_sweep_fwd(t, dt, y, k1, (W1, b1, W2, b2))

    @staticmethod
    def backward(ctx, *cts):
        t, dt, y, k1, *leaves = ctx.saved_tensors
        cts = tuple(torch.zeros_like(y) if c is None else c.contiguous() for c in cts)
        ct_t, ct_dt, ct_y, ct_k1, ct_leaves = stage_sweep_bwd(t, dt, y, k1, leaves, cts)
        return (ct_t.to(t.dtype).reshape(t.shape), ct_dt.to(dt.dtype).reshape(dt.shape),
                ct_y, ct_k1, *ct_leaves)


def mlp_dynamics_stage_sweep(t, dt, y, k1, leaves):
    """``stage_sweep`` for ``ops.ode.odeint`` over MLPDynamics leaves
    ``(W1, b1, W2, b2)`` in the tuple protocol, ``(y_new, k7, err, k6,
    g6)`` (``pallas_mlp.mlp_dynamics_stage_sweep``); differentiable through
    ``StageSweepFn`` (K13/K14)::

        sol = odeint(node._func, x, 0.0, 1.0, leaves,
                     stage_sweep=mlp_dynamics_stage_sweep)
    """
    t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
    dt = torch.as_tensor(dt, dtype=y.dtype, device=y.device)
    return StageSweepFn.apply(t, dt, y, k1, *leaves)


def plain_mlp_stage_sweep(t, dt, y, k1, leaves):
    """The plain version of K13 on any device, as a ``stage_sweep``: the
    same trial-step algebra with no kernel, differentiated by autograd."""
    return _reference_sweep(t, dt, y, k1, _split_params(*leaves))


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
