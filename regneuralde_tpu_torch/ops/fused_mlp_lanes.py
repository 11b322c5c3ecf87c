"""Lane-wise Tsit5 trial step of ``MLPDynamics``: plain PyTorch and CUDA kernels.

Counterpart of the lane-wise part of ``regneuralde_tpu/ops/pallas_mlp.py``
(``_reference_sweep_lanes``, ``_pallas_sweep_lanes``, ``_pallas_bwd_lanes``,
``mlp_dynamics_sweep_lanes``). The per-sample batched engine
(``ops.per_sample_batched``) advances every batch row under its own
controller, so a trial step has a ``(batch,)`` vector of times and step
sizes: row ``i`` runs the six Tsit5 stages at its own ``(t_i, dt_i)``. The
step returns ``(y_new, k7, err, k6, g6)``, each ``(batch, dim)``: the new
state, the last stage derivative (FSAL), the embedded error ``dt_i *
sum_j btilde_j (k_j - k1)``, the stage-6 derivative and the stage-5 state
(the stiffness estimate's two differences).

The weights are the four leaves ``(W1, b1, W2, b2)`` of
``models.basic.MLPDynamics`` (``nn.Linear`` layout, time column last).

Each affine map is summed in float64 and rounded once to float32, in the
plain version (``_mlp_k_lanes``) and in K11 alike, and the stage and error
lincombs round each multiply and add as PyTorch's separate ops do: the
forward kernel K11 reproduces its plain version rounding for rounding, so a
per-lane accept decision at the error estimate's float32 floor is the same
on both (512 lanes each decide on their own norm).

Each step has a plain version (``_reference_sweep_lanes``, and
``_lanes_bwd_math``, the hand reverse chain of
``pallas_mlp._fused_bwd_kernel_lanes``) and a CUDA kernel. K11 is one trial
step of the whole solve's grid-split stages at per-row times,
``mlp_step_solve_kernel<LaneEnd>`` (``csrc/mlp_step_solve.cuh``, the stages'
``F64`` rounding policy in ``csrc/mlp_solve.cuh``: both contractions in
float64, each affine map rounded once; its schedule
``whole_solve.plain_lanes_solve_step``), on K12's tile plan. K12 is one
trial step of the whole solve's walk at per-row times,
``mlp_step_walk_kernel<LaneSeed>`` (``csrc/mlp_step_walk.cuh``; its schedule
``whole_solve.plain_lanes_walk_step``) + ``csrc/weight_cotangents.cu``.
K12's replay rounds the stages as the whole solve's (``F32``: sums over D
in float32 column blocks), not as K11's: the engine takes its accept flags
from the forward, so K12's rounding moves gradients only. The wrappers
``sweep_lanes_fwd`` and ``sweep_lanes_bwd`` take the plain version for
tensors on the CPU, launch the kernel for tensors on a CUDA device, and
raise otherwise.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import weight_cotangents as wc
from regneuralde_tpu_torch.ops.fused_mlp import _check_cuda_args, _ptr, _split_params, _stage_acc
from regneuralde_tpu_torch.ops.math import tanh as _tanh
from regneuralde_tpu_torch.ops.tableaus import TSIT5

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"mlp_lanes_tsit5_fwd": 0, "mlp_lanes_tsit5_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _affine(x, w, tcol, wt, b):
    """``x w^T + tcol wt + b`` summed in float64 (at least) and rounded once
    to ``x``'s type; ``tcol`` is the ``(batch, 1)`` time column."""
    d = torch.promote_types(x.dtype, torch.float64)
    acc = torch.addmm(tcol.to(d) * wt.to(d) + b.to(d), x.to(d), w.to(d).T)
    return acc.to(x.dtype)


def _mlp_k_lanes(yi, ti, parts):
    """One MLPDynamics evaluation with a per-row time column ``ti``:
    ``(k, h)``, the stage derivative and the hidden activations."""
    w1x, w1t, b1, w2h, w2t, b2 = parts
    h = _tanh(_affine(yi, w1x, ti, w1t, b1))
    return _tanh(_affine(h, w2h, ti, w2t, b2)), h


def _reference_sweep_lanes(tc, dtc, y, k1, parts):
    """Plain version of K11: ``(y_new, k7, err, k6, g6)``. ``tc``/``dtc``
    are ``(batch, 1)`` columns; everything else as ``fused_mlp._reference_sweep``."""
    ks = [k1]
    y_stage = y
    g6 = y
    for i in range(1, 7):
        y_stage = y + dtc * _stage_acc(i, ks)
        ks.append(_mlp_k_lanes(y_stage, tc + TSIT5.c[i] * dtc, parts)[0])
        if i == 5:
            g6 = y_stage
    err = TSIT5.btilde[1] * (ks[1] - ks[0])
    for c, k in zip(TSIT5.btilde[2:], ks[2:]):
        err = err + c * (k - ks[0])
    return y_stage, ks[-1], dtc * err, ks[-2], g6


def _lanes_bwd_math(tc, dtc, y, k1, parts, cts):
    """Plain version of K12: the hand reverse chain of the lane-wise step
    (``pallas_mlp._fused_bwd_kernel_lanes``).

    Maps ``cts = (ct_y_new, ct_k7, ct_err, ct_k6, ct_g6)`` to ``(ct_t,
    ct_dt, ct_y, ct_k1, (cW1, cb1, cW2, cb2))``; ``ct_t``/``ct_dt`` are
    ``(batch,)``: each lane's time and step size feed only its own row. The
    time columns' weight cotangents contract the per-row stage time against
    the pre-activation cotangents over the batch."""
    tab = TSIT5
    w1x, w1t, b1, w2h, w2t, b2 = parts
    cyn, ck7, cerr, ck6, cg6 = cts

    ks, yis, hs = [k1], [], []
    for i in range(1, 7):
        yi = y + dtc * _stage_acc(i, ks)
        k, h = _mlp_k_lanes(yi, tc + tab.c[i] * dtc, parts)
        ks.append(k)
        yis.append(yi)
        hs.append(h)

    ct_ks = [tab.btilde[j] * (dtc * cerr) for j in range(7)]
    ct_ks[6] = ct_ks[6] + ck7
    ct_ks[5] = ct_ks[5] + ck6
    seeds = {6: cyn, 5: cg6}

    s_comb = tab.btilde[1] * (ks[1] - ks[0])
    for c, k in zip(tab.btilde[2:], ks[2:]):
        s_comb = s_comb + c * (k - ks[0])
    ct_dt = torch.sum(cerr * s_comb, dim=1, keepdim=True)
    ct_t = torch.zeros_like(ct_dt)
    ct_y = torch.zeros_like(y)
    cw1x, cw1t, cb1 = torch.zeros_like(w1x), torch.zeros_like(w1t), torch.zeros_like(b1)
    cw2h, cw2t, cb2 = torch.zeros_like(w2h), torch.zeros_like(w2t), torch.zeros_like(b2)
    for i in range(6, 0, -1):
        k_i, h_i, yi = ks[i], hs[i - 1], yis[i - 1]
        ti = tc + tab.c[i] * dtc

        ct_pre2 = ct_ks[i] * (1.0 - k_i * k_i)
        cw2h = cw2h + ct_pre2.T @ h_i
        cw2t = cw2t + (ct_pre2.T @ ti)[:, 0]
        cb2 = cb2 + torch.sum(ct_pre2, dim=0)
        ct_ti = torch.sum(ct_pre2 * w2t, dim=1, keepdim=True)

        ct_pre1 = (ct_pre2 @ w2h) * (1.0 - h_i * h_i)
        cw1x = cw1x + ct_pre1.T @ yi
        cw1t = cw1t + (ct_pre1.T @ ti)[:, 0]
        cb1 = cb1 + torch.sum(ct_pre1, dim=0)
        ct_ti = ct_ti + torch.sum(ct_pre1 * w1t, dim=1, keepdim=True)

        ct_yi = ct_pre1 @ w1x
        if i in seeds:
            ct_yi = seeds[i] + ct_yi
        ct_y = ct_y + ct_yi
        ct_dt = (ct_dt + torch.sum(ct_yi * _stage_acc(i, ks), dim=1, keepdim=True)
                 + tab.c[i] * ct_ti)
        ct_t = ct_t + ct_ti
        for j, c in enumerate(tab.a[i - 1]):
            if c != 0.0:
                ct_ks[j] = ct_ks[j] + (dtc * c) * ct_yi

    ct_leaves = (torch.cat([cw1x, cw1t[:, None]], dim=1), cb1,
                 torch.cat([cw2h, cw2t[:, None]], dim=1), cb2)
    return ct_t[:, 0], ct_dt[:, 0], ct_y, ct_ks[0], ct_leaves


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, kernel for CUDA tensors.
# ---------------------------------------------------------------------------


def _lane_f32(x, y, name):
    """A ``(batch,)`` time or step-size vector as the kernels take it."""
    if not isinstance(x, torch.Tensor) or x.device != y.device:
        raise ValueError(f"{name} must be a tensor on {y.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != (y.shape[0],):
        raise ValueError(f"{name} must have shape ({y.shape[0]},), got {tuple(x.shape)}")
    return x.contiguous()


def _cuda_lanes_fwd(t, dt, y, k1, leaves):
    """K11: one cooperative launch of ``csrc/mlp_step_solve.cuh`` with the
    lane end, K3's six stages at every row's own ``(t, dt)`` rounded as the
    plain version (``F64``) on K12's tile plan, then each tile's five rows;
    no host sync."""
    from regneuralde_tpu_torch.ops import _cuda
    from regneuralde_tpu_torch.ops import whole_solve as ws

    B, D, H = _check_cuda_args(y, k1, leaves)
    t32, dt32 = _lane_f32(t, y, "t"), _lane_f32(dt, y, "dt")
    lib = _cuda.library()
    plan = ws._cuda_walk_plan(lib, B, D, H, y.device, lanes=True)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    scratch = fm._step_solve_scratch(lib, plan, H, y.device, stream, lanes=True)
    outs = [torch.empty_like(y) for _ in range(5)]
    code = lib.regnde_lanes_fwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), *map(_ptr, leaves), *map(_ptr, outs),
        _ptr(scratch), B, D, H, plan.rows, plan.cols, plan.row_blocks, plan.col_blocks,
        plan.chunks, ctypes.c_void_p(stream))
    _cuda.check(code, "lane-wise Tsit5 forward kernel")
    LAUNCHES["mlp_lanes_tsit5_fwd"] += 1
    return tuple(outs)


def _cuda_lanes_bwd(t, dt, y, k1, leaves, cts):
    """K12: one cooperative launch of ``csrc/mlp_step_walk.cuh`` with the
    tuple's five row seeds at every row's own ``(t, dt)`` on the whole
    solve's tile plan, then the weight-cotangent contraction; no host
    sync."""
    from regneuralde_tpu_torch.ops import _cuda

    names = ("ct_y_new", "ct_k7", "ct_err", "ct_k6", "ct_g6")
    _check_cuda_args(y, k1, leaves, {n: (c, tuple(y.shape)) for n, c in zip(names, cts)})
    t32, dt32 = _lane_f32(t, y, "t"), _lane_f32(dt, y, "dt")
    lib = _cuda.library()
    outs, bufs, sizes = fm._step_walk_buffers(lib, y, leaves, lanes=True)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    code = lib.regnde_lanes_bwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), *map(_ptr, leaves), *map(_ptr, cts),
        *map(_ptr, bufs), *sizes, ctypes.c_void_p(stream))
    _cuda.check(code, "lane-wise Tsit5 backward kernel")
    LAUNCHES["mlp_lanes_tsit5_bwd"] += 1
    wc.count_launch()
    return outs


def sweep_lanes_fwd(t, dt, y, k1, leaves: Sequence[torch.Tensor]):
    """K11 or its plain version: ``(y_new, k7, err, k6, g6)`` for
    ``(batch,)`` ``t`` and ``dt``."""
    if y.device.type == "cuda":
        return _cuda_lanes_fwd(t, dt, y, k1, tuple(leaves))
    if y.device.type == "cpu":
        return _reference_sweep_lanes(t[:, None], dt[:, None], y, k1, _split_params(*leaves))
    raise RuntimeError(f"no lane-wise Tsit5 forward for device {y.device}")


def sweep_lanes_bwd(t, dt, y, k1, leaves: Sequence[torch.Tensor], cts):
    """K12 or its plain version: ``(ct_t, ct_dt, ct_y, ct_k1, ct_leaves)``."""
    if y.device.type == "cuda":
        return _cuda_lanes_bwd(t, dt, y, k1, tuple(leaves), tuple(cts))
    if y.device.type == "cpu":
        return _lanes_bwd_math(t[:, None], dt[:, None], y, k1, _split_params(*leaves),
                               tuple(cts))
    raise RuntimeError(f"no lane-wise Tsit5 backward for device {y.device}")


class SweepLanesFn(torch.autograd.Function):
    """The lane-wise trial step, K11 forward and K12 backward (their plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, t, dt, y, k1, W1, b1, W2, b2):
        ctx.save_for_backward(t, dt, y, k1, W1, b1, W2, b2)
        return sweep_lanes_fwd(t, dt, y, k1, (W1, b1, W2, b2))

    @staticmethod
    def backward(ctx, *cts):
        t, dt, y, k1, *leaves = ctx.saved_tensors
        cts = tuple(torch.zeros_like(y) if c is None else c.contiguous() for c in cts)
        ct_t, ct_dt, ct_y, ct_k1, ct_leaves = sweep_lanes_bwd(t, dt, y, k1, leaves, cts)
        return ct_t.to(t.dtype), ct_dt.to(dt.dtype), ct_y, ct_k1, *ct_leaves


def mlp_dynamics_sweep_lanes(t, dt, y, k1, leaves):
    """Lane-wise ``stage_sweep_lanes`` of the per-sample batched engine over
    MLPDynamics leaves ``(W1, b1, W2, b2)``: ``(y_new, k7, err, k6, g6)``
    with every row advanced at its own ``(t_i, dt_i)``; differentiable
    through ``SweepLanesFn`` (K11/K12)."""
    return SweepLanesFn.apply(t, dt, y, k1, *leaves)


def mlp_dynamics_sweep_lanes_bwd(t, dt, y, k1, leaves, cts) -> Tuple:
    """Direct backward of the lane-wise step for the engine's adjoint: one
    K12 launch (or its plain version), no forward replay."""
    return sweep_lanes_bwd(t, dt, y, k1, tuple(leaves), tuple(cts))


def plain_mlp_sweep_lanes(t, dt, y, k1, leaves):
    """The plain version of K11 on any device: the lane-wise sweep of
    ``NeuralODE(per_sample="batched", fused=False)`` for MLPDynamics."""
    return _reference_sweep_lanes(t[:, None], dt[:, None], y, k1, _split_params(*leaves))


def plain_mlp_sweep_lanes_bwd(t, dt, y, k1, leaves, cts):
    """The plain version of K12 on any device."""
    return _lanes_bwd_math(t[:, None], dt[:, None], y, k1, _split_params(*leaves),
                           tuple(cts))
