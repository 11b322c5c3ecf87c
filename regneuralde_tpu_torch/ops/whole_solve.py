"""Whole adaptive Tsit5 solve: one kernel per direction.

Counterpart of ``regneuralde_tpu/ops/pallas_solve.py``: ``whole_solve_odeint``
(the monolithic engine, K3/K4) and ``whole_solve_odeint_tiled`` (the tiled
engine, K5/K6) become one pair of persistent CUDA kernels
(``csrc/whole_solve.cu``), generic over the dynamics' trial step:
``dynamics="mlp"`` (``MLPDynamics``, K1/K2's tile bodies), ``"altmlp"``
(``AlternatingMLP``, K7/K8's) or ``"csl"`` (FFJORD's augmented
``CSLDynamics`` with the Hutchinson probe as its last leaf, K7/K8-CSL's;
its probe's cotangent is zeros). The forward runs every trial step of the
adaptive loop on the device, with the Hermite ``saveat`` writes; the
backward walks its history in reverse, with their pullback. Neither returns
to the host between trial steps.

The forward's record (``SolveRecord``) is what the backward reads: per
trial step its start state ``t, dt, qold``, the three norm sums, the
accept flag and the rows ``y, f0``; the ``saveat`` rows and the save
cursors. The backward takes the stored accept flags and norm sums (the
tiled engine's choice, ``pallas_solve.py`` ``make_whole_solve_tiled``) and
re-runs the scalar chain only to pull cotangents back through it, with the
hand pullback ``ode.post_bwd``.

For ``MLPDynamics`` the forward also streams each trial step's stage
residuals, the six fresh stage derivatives ``ks`` and hidden activations
``hs`` (``make_whole_solve(cache_residuals=True)``, which JAX's
``whole_solve_odeint`` turns on for this dynamics): the backward feeds
them to the trial step's hand pullback and never re-runs the stage sweep.
``cache_residuals=False`` keeps the replay; it serves only to check the
stream against it, bitwise. Its forward (``csrc/mlp_solve.cuh``) and its
backward (``csrc/mlp_walk.cuh``) split each stage's two contractions over
the whole grid, one block a tile of the batch, on one tile plan
(``walk_plan``); ``plain_solve_step`` and ``plain_walk_step`` are one trial
step of each in the kernel's own schedule, for the tests. K2, K14 and K12,
the normed, the tuple and the lane-wise step's backwards
(``fused_mlp.normed_sweep_bwd``, ``fused_mlp.stage_sweep_bwd``,
``fused_mlp_lanes.sweep_lanes_bwd``), are one trial step of that walk on the
plan, with the walk's own seeds, with the tuple's, and with the tuple's at
every row's own time (``plain_normed_walk_step``, ``plain_tuple_walk_step``,
``plain_lanes_walk_step``). K13, K1 and K11, the tuple, the normed and
the lane-wise step themselves (``fused_mlp.stage_sweep_fwd``,
``fused_mlp.normed_sweep_fwd``, ``fused_mlp_lanes.sweep_lanes_fwd``), are one
trial step of the forward's stages on the plan (``plain_tuple_solve_step``,
``plain_normed_solve_step``; ``plain_lanes_solve_step``, whose stages sum
their affine maps in float64 as K11's plain version does).

Each kernel has a plain version with the same algebra and the same output
buffers, over the dynamics' plain trial-step pair (``plain_steps``):
``plain_whole_solve_fwd`` (the trial-step loop of ``ode._solve_forward``
with ``ode._HermiteSaver``) and ``plain_whole_solve_bwd`` (the reverse walk
of ``ode.FastAdjointSolve`` with ``post_bwd`` in place of autograd). The
wrappers ``whole_solve_fwd`` and ``whole_solve_bwd`` take the plain version
for tensors on the CPU, launch the kernel for tensors on a CUDA device,
and raise otherwise.

``saveat`` must be monotone in the direction of integration: the kernels
consume it with a cursor (``pallas_solve.py``'s), not a window mask.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from regneuralde_tpu_torch.ops import fused_csl as fc
from regneuralde_tpu_torch.ops import fused_generic as fg
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import weight_cotangents as wc
from regneuralde_tpu_torch.ops.controller import PIController
from regneuralde_tpu_torch.ops.ode import (
    AdjointCarry,
    NormedSweep,
    ODESolution,
    StepTelemetry,
    _HermiteSaver,
    _post,
    _solve_forward,
    adjoint_step,
    hermite_pullback,
    post_bwd,
    saveat_rows,
    solve_prologue,
    solve_stats,
)
from regneuralde_tpu_torch.ops.tableaus import TSIT5

# Launches of each kernel, counted by its wrapper where it launches: K3 and
# K4 for MLPDynamics, for AlternatingMLP and for FFJORD's CSL dynamics.
LAUNCHES = {"whole_solve_fwd": 0, "whole_solve_bwd": 0,
            "whole_solve_altmlp_fwd": 0, "whole_solve_altmlp_bwd": 0,
            "whole_solve_csl_fwd": 0, "whole_solve_csl_bwd": 0}

DYNAMICS = ("mlp", "altmlp", "csl")


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
    trial step ``i`` for ``i <= ns`` (``hy[ns]`` is ``y1``, ``hf[ns]`` its
    derivative; an accepted step's ``y_new, k7`` are the next rows); later
    rows are undefined. ``streams`` is ``(11, S)``: per trial step its start
    ``t, dt, qold``, the norm sums ``err_ssq, num_ssq, den_ssq``, the accept
    flag (1.0 or 0.0), and the telemetry ``t_end, dt_eff, eest,
    eigen_est``; zero past step ``ns``. ``final`` is ``(t, dt, qold,
    naccept, nreject, done)``. ``ys`` holds the ``saveat`` rows (empty
    without ``saveat``) and ``cursors`` (int32) the save cursors ``(cur0,
    curf)``: rows ``[0, cur0)`` lie at or before ``t0`` and keep
    ``ys_init``, rows ``[cur0, curf)`` were written, later rows were not
    reached and keep ``ys_init``.

    ``ks`` ``(S, 6, B, D)`` and ``hs`` ``(S, 6, B, H)`` are the stage
    residuals of ``MLPDynamics``: row ``i`` holds trial step ``i``'s six
    fresh stage derivatives ``k2..k7`` and each stage's hidden activations,
    rejected steps included, as the rows of ``hy``/``hf``; rows past
    ``ns`` are undefined. Both are empty (shape ``(0,)``) for
    ``"altmlp"`` and ``"csl"``, and for a solve without the stream."""

    y1: torch.Tensor
    hy: torch.Tensor
    hf: torch.Tensor
    streams: torch.Tensor
    final: torch.Tensor
    ys: torch.Tensor
    cursors: torch.Tensor
    ks: torch.Tensor
    hs: torch.Tensor


def plain_steps(dynamics: str, rtol, atol):
    """The plain trial-step pair ``(sweep, sweep_bwd)`` over the leaves:
    K1/K2's plain versions for ``"mlp"``, K7/K8's for ``"altmlp"`` and
    K7/K8-CSL's for ``"csl"``."""
    rtol, atol = float(rtol), float(atol)
    if dynamics == "mlp":
        return (lambda t, dt, y, k1, lv: fm.plain_mlp_normed_sweep(t, dt, y, k1, lv, rtol,
                                                                    atol),
                lambda t, dt, y, k1, lv, cts: fm.plain_mlp_normed_sweep_bwd(
                    t, dt, y, k1, lv, cts, rtol, atol))
    if dynamics == "altmlp":
        return fg.make_plain_alternating_mlp_sweep(rtol, atol)
    if dynamics == "csl":
        return fc.make_plain_csl_sweep(rtol, atol)
    raise ValueError(f"dynamics must be one of {DYNAMICS}, got {dynamics!r}")


def _streams_residuals(dynamics, cache_residuals):
    """Whether the solve streams the stage residuals: ``MLPDynamics``
    only, the one dynamics with a hand pullback that takes them."""
    return cache_residuals and dynamics == "mlp"


# ---------------------------------------------------------------------------
# The tile plan of K3 and K4's walk for MLPDynamics (csrc/mlp_solve.cuh,
# csrc/mlp_walk.cuh).
# ---------------------------------------------------------------------------

WALK_ROWS = (32, 16)  # tile heights (4-row groups a power of two), preferred first
WALK_COL_ALIGN = 4  # kWalkTN: tile widths are a multiple (a register tile's columns)
WALK_MAX_TILE = 4096  # kWalkRounds * kThreads * kWalkTM: the row passes' registers
WALK_SLAB_ROWS, WALK_SLABS = 8, 4  # kWalkKB, kWalkStages
WALK_STATE = 13  # kWalkState: floats of reverse state an element
LANE_STATE = 14  # kLaneState: K12's, with each element's share of its row's ct_dt
LANE_ROW_FLOATS = 5 * 32  # kLaneRowFloats: K12's LaneRows, five floats of each of a tile's rows
SOLVE_STATE = 9  # kSolveState: floats of K3's state an element
WALK_MIN_COLS = 32  # a warp of columns at least, where D allows
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use (H100)
_WARPS = 8


class WalkPlan(NamedTuple):
    """Tiles of ``rows x cols`` of the batch's ``B x D`` elements,
    ``row_blocks x col_blocks`` of them (one block each, all resident);
    the batch walked in ``chunks`` of ``row_blocks * rows`` rows;
    ``smem_bytes`` of dynamic shared memory a block."""

    rows: int
    cols: int
    row_blocks: int
    col_blocks: int
    chunks: int
    smem_bytes: int

    @property
    def tiles(self) -> int:
        return self.row_blocks * self.col_blocks


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def solve_smem_bytes(R: int, C: int, H: int, lanes: bool = False) -> int:
    """K3's shared memory for tiles of ``R x C`` (``solve_smem_floats`` of
    ``csrc/mlp_solve.cuh``): the state (y, k1..k7), the stage input (its
    columns rounded to a slab), the row block's hidden rows (H rounded to a
    slab), the slab ring (rows of H rounded to ``WALK_COL_ALIGN``, or C) and
    the block sum's scratch. With ``lanes``, K11's (``F64``, the tile's
    ``LaneRows``): the stage input, the hidden rows and the slab ring in
    doubles, the tile's rows last."""
    slab = max(_round_up(H, WALK_COL_ALIGN), C)
    w = 2 if lanes else 1  # floats of the contractions' operands
    floats = (R * ((SOLVE_STATE - 1) * C + w * _round_up(C, WALK_SLAB_ROWS)
                   + w * _round_up(H, WALK_SLAB_ROWS))
              + w * WALK_SLABS * WALK_SLAB_ROWS * slab + 3 * _WARPS
              + (LANE_ROW_FLOATS if lanes else 0))
    return 4 * floats


def walk_smem_bytes(R: int, C: int, H: int, state: int = WALK_STATE) -> int:
    """The walk's shared memory for tiles of ``R x C`` (``walk_smem_bytes``
    of ``csrc/mlp_walk.cuh``): the state (``state`` floats an element:
    ``WALK_STATE``, or K12's ``LANE_STATE``), ct_pre2 of the tile and
    ct_pre1 of the row block (their columns rounded to a slab), the slab
    ring (rows of H+1 floats, rounded to ``WALK_COL_ALIGN``, or C), the
    block sum's scratch and, with ``LANE_STATE``, K12's rows of the tile
    (their times and sums). The replay's stages reuse it: K3's
    (``solve_smem_bytes``) is below it term by term."""
    slab = max(_round_up(H + 1, WALK_COL_ALIGN), C)
    floats = (R * (state * C + _round_up(C, WALK_SLAB_ROWS)
                   + _round_up(H, WALK_SLAB_ROWS))
              + WALK_SLABS * WALK_SLAB_ROWS * slab + 4 * _WARPS
              + (LANE_ROW_FLOATS if state == LANE_STATE else 0))
    return 4 * floats


@functools.lru_cache(maxsize=64)
def walk_plan(B: int, D: int, H: int, sms: int, limit: int = SMEM_LIMIT,
              state: int = WALK_STATE) -> WalkPlan:
    """The tile plan of K3 and K4's walk at ``B x D x H`` on ``sms``
    multiprocessors (K3 streams each trial step on the tiles K4's replay
    recomputes it on):
    the fewest row chunks, then the most tiles (at most one a
    multiprocessor), then the fewest padding rows, then the taller tiles
    (fewer reads of the weights), over tiles of 32 or 16 rows and a multiple
    of ``WALK_COL_ALIGN`` columns, at least ``WALK_MIN_COLS`` where D allows,
    of at most ``WALK_MAX_TILE`` elements, whose shared memory fits
    ``limit`` with ``state`` floats of state an element (K12's plan takes
    ``LANE_STATE``, and K11's shared memory fits it too, K11 running on
    K12's tiles). 32 x 100, 128 tiles, at 512 x 784 x 100. Cached: K13,
    K1, K11, K2, K14 and K12 ask for it every trial step, and the search
    takes about 0.25 ms."""
    best, best_key = None, None
    widths = sorted({_round_up(-(-D // n), WALK_COL_ALIGN) for n in range(1, D + 1)})
    for R in WALK_ROWS:
        for C in widths:
            ndb = -(-D // C)
            if (C < WALK_MIN_COLS and ndb > 1) or R * C > WALK_MAX_TILE or ndb > sms:
                continue
            smem = walk_smem_bytes(R, C, H, state)
            if smem > limit or (state == LANE_STATE
                                and solve_smem_bytes(R, C, H, lanes=True) > limit):
                continue
            nrb = min(-(-B // R), sms // ndb)
            chunks = -(-B // (nrb * R))
            key = (chunks, -nrb * ndb, chunks * nrb * R - B, -R)
            if best_key is None or key < best_key:
                best, best_key = WalkPlan(R, C, nrb, ndb, chunks, smem), key
    if best is None:
        raise ValueError(f"no tile plan of K4's walk fits {limit} bytes of shared "
                         f"memory at D={D}, H={H}")
    return best


def plain_solve_step(t, dt, y, k1, leaves, rtol, atol, plan: WalkPlan):
    """One trial step of K3 for MLPDynamics in the kernel's own schedule:
    per stage ``i = 1..6`` the stage input ``y_i = y + dt acc_i``; phase A,
    ``y_i W1x^T``, one partial per column block of ``plan``; the reduction,
    the partials summed in block order, ``t_i w1t + b1`` added and tanh
    taken (``h_i``); phase B, ``k_i = tanh(h_i W2h^T + t_i w2t + b2)``;
    then the norm sums. Returns ``fm._reference_normed_sweep_res``'s
    ``(outs, (ks, hs))``. For the tests: the kernel's arithmetic in this
    order."""
    ks, hs = _solve_stages(t, dt, y, k1, leaves, plan)
    return fm._normed_outs(dt, y, ks, rtol, atol), (ks, hs)


def _spans(D, plan: WalkPlan):
    """The column blocks of ``plan`` over D columns, as ``(start, end)``."""
    return [(q * plan.cols, min(D, (q + 1) * plan.cols)) for q in range(plan.col_blocks)]


def _solve_stages(t, dt, y, k1, leaves, plan: WalkPlan):
    """K3's six stages in its schedule (``plain_solve_step``): the stage
    derivatives ``ks`` (k1 first) and each stage's hidden layer ``hs``.
    ``t`` and ``dt`` are the step's scalars or, for K12, ``(B, 1)``
    columns: every row at its own time."""
    w1x, w1t, b1, w2h, w2t, b2 = fm._split_params(*leaves)
    spans = _spans(y.shape[1], plan)
    ks, hs = [k1], []
    for i in range(1, 7):
        yi = y + dt * fm._stage_acc(i, ks)
        ti = t + TSIT5.c[i] * dt
        h = fm._tanh(sum(yi[:, a:b] @ w1x[:, a:b].T for a, b in spans) + ti * w1t + b1)
        ks.append(fm._tanh(h @ w2h.T + ti * w2t + b2))
        hs.append(h)
    return ks, hs


def plain_walk_step(t, dt, y, k1, leaves, cts, rtol, atol, res, plan: WalkPlan,
                    pass_y=None, pass_k1=None):
    """One trial step of K4's walk for MLPDynamics in the kernel's own
    schedule, on the stage residuals ``res = (ks, hs)`` (``ks`` k1 first):
    the seed phase, where the seeds of the stage-6 and stage-5 inputs enter
    ``cty``, ``cks`` and ``ct_dt`` as those stages' ``ct_yi`` carry them;
    then the six reverse stages (``_walk_stages``). ``cts = (ct_y_new,
    ct_k7, ct_err_ssq, ct_num_ssq, ct_den_ssq)``; the row cotangents may be
    None (a rejected step). Returns ``(ct_t, ct_dt, pass_y + ct_y, pass_k1 +
    ct_k1, (cp2, he, cp1, ye))``, the rows in the layout the contraction
    reads (stage ``i`` at ``(i - 1) B``). For the tests: the kernel's
    arithmetic is ``fm._normed_bwd_math``'s in this order."""
    tab = TSIT5
    ks, hs = [k1, *res[0]], list(res[1])
    cyn, ck7, c_err, c_num, c_den = cts
    zero = torch.zeros_like(y)
    cyn = zero if cyn is None else cyn
    ck7 = zero if ck7 is None else ck7

    # ---- the seed phase ----
    yn, g6 = y + dt * fm._stage_acc(6, ks), y + dt * fm._stage_acc(5, ks)
    s_comb = fm._err_comb(ks)
    denom = atol + torch.maximum(torch.abs(y), torch.abs(yn)) * rtol
    scaled = dt * s_comb / denom
    cerr = c_err * 2.0 * scaled / denom
    cdenom = c_err * (-2.0) * scaled * scaled / denom
    y_is_max = torch.abs(y) >= torch.abs(yn)
    to_y = torch.where(y_is_max, cdenom * rtol * torch.sign(y), zero)
    to_ynew = torch.where(y_is_max, zero, cdenom * rtol * torch.sign(yn))
    d_k7 = c_num * 2.0 * (ks[6] - ks[5])
    d_ynew = c_den * 2.0 * (yn - g6)
    cks = [tab.btilde[j] * (dt * cerr) for j in range(6)]
    cks[5] = cks[5] - d_k7
    cp2 = (tab.btilde[6] * (dt * cerr) + ck7 + d_k7) * (1.0 - ks[6] * ks[6])
    ct_t, ct_dt, cty, ct_k1, rows = _walk_stages(
        t, dt, y, leaves, ks, hs, cks, cp2, to_y, torch.sum(cerr * s_comb),
        {6: cyn + d_ynew + to_ynew, 5: -d_ynew}, plan)
    ct_y = cty if pass_y is None else pass_y + cty
    ct_k1 = ct_k1 if pass_k1 is None else pass_k1 + ct_k1
    return ct_t, ct_dt, ct_y, ct_k1, rows


def plain_normed_walk_step(t, dt, y, k1, leaves, cts, rtol, atol, plan: WalkPlan):
    """One launch of K2 (``csrc/mlp_step_walk.cuh``), the normed step's
    backward, in the kernel's own schedule: the replay, K3's six stages on
    ``plan`` (``_solve_stages``), then K4's trial step on them
    (``plain_walk_step``, the seeds of ``cts = (ct_y_new, ct_k7, ct_err_ssq,
    ct_num_ssq, ct_den_ssq)`` and the six reverse stages, nothing passed
    through). Returns ``(ct_t, ct_dt, ct_y, ct_k1, (cp2, he, cp1, ye))`` as
    ``plain_walk_step``. For the tests: the kernel's arithmetic is
    ``fm._normed_bwd_math``'s in this order."""
    ks, hs = _solve_stages(t, dt, y, k1, leaves, plan)
    return plain_walk_step(t, dt, y, k1, leaves, cts, rtol, atol, (ks[1:], hs), plan)


def plain_tuple_walk_step(t, dt, y, k1, leaves, cts, plan: WalkPlan):
    """One launch of K14 (``csrc/mlp_step_walk.cuh``), the tuple step's
    backward, in the kernel's own schedule: the replay, K3's six stages on
    ``plan`` (``_solve_stages``); the seed phase, where the row cotangents
    ``cts = (ct_y_new, ct_k7, ct_err, ct_k6, ct_g6)`` enter as
    ``fm._bwd_math`` seeds them (``btilde_j dt ct_err`` into every stage
    derivative's cotangent, ``ct_k7`` and ``ct_k6`` into k7's and k6's,
    ``ct_y_new`` and ``ct_g6`` as stage 6's and stage 5's input seeds,
    carried into ``cty``, ``cks`` and ``ct_dt`` as those stages' ``ct_yi``
    carry them); then the walk's six reverse stages (``_walk_stages``).
    Returns ``(ct_t, ct_dt, ct_y, ct_k1, (cp2, he, cp1, ye))`` as
    ``plain_walk_step``. For the tests: the kernel's arithmetic is
    ``fm._bwd_math``'s in this order. At ``(B, 1)`` time columns ``t`` and
    ``dt`` it is K12's (``plain_lanes_walk_step``), ``ct_t`` and ``ct_dt``
    ``(B, 1)``."""
    tab = TSIT5
    cyn, ck7, cerr, ck6, cg6 = cts
    ks, hs = _solve_stages(t, dt, y, k1, leaves, plan)
    cks = [tab.btilde[j] * (dt * cerr) for j in range(6)]
    cks[5] = cks[5] + ck6
    cp2 = (tab.btilde[6] * (dt * cerr) + ck7) * (1.0 - ks[6] * ks[6])
    return _walk_stages(t, dt, y, leaves, ks, hs, cks, cp2, torch.zeros_like(y),
                        _sum_for(dt)(cerr * fm._err_comb(ks)), {6: cyn, 5: cg6}, plan)


def plain_tuple_solve_step(t, dt, y, k1, leaves, plan: WalkPlan):
    """One launch of K13 (``csrc/mlp_step_solve.cuh``), the tuple step, in
    the kernel's own schedule: K3's six stages on ``plan``
    (``_solve_stages``), then each tile's rows as ``fm._reference_sweep``
    forms them, ``(y_new, k7, err, k6, g6)``: the stage-6 input, k7, dt
    times the btilde combination of ``k_j - k1`` summed from j = 1 up, k6
    and the stage-5 input. For the tests: the kernel's arithmetic in this
    order."""
    ks, _ = _solve_stages(t, dt, y, k1, leaves, plan)
    return (y + dt * fm._stage_acc(6, ks), ks[6], dt * fm._err_comb(ks), ks[5],
            y + dt * fm._stage_acc(5, ks))


def plain_lanes_solve_step(t, dt, y, k1, leaves, plan: WalkPlan):
    """One launch of K11 (``csrc/mlp_step_solve.cuh`` with ``LaneEnd``), the
    lane-wise step, in the kernel's own schedule, every row at its own time
    (``t`` and ``dt`` ``(B,)``): per stage ``i = 1..6`` the stage input
    ``y + dt acc_i``, each multiply and add rounded (``fm._stage_acc``'s
    order); phase A, ``y_i W1x^T`` in float64 (at least), one partial per
    column block of ``plan``, summed in block order, then ``t_i w1t + b1``
    added in float64, rounded once to y's type, tanh; phase B likewise over
    all of H; then the five rows as ``plain_tuple_solve_step`` forms them.
    For the tests: the kernel's arithmetic (the ``F64`` rounding policy) in
    this order, which ``fused_mlp_lanes._reference_sweep_lanes`` takes in
    one float64 ``addmm`` a map."""
    w1x, w1t, b1, w2h, w2t, b2 = fm._split_params(*leaves)
    tc, dtc = t[:, None], dt[:, None]
    wide = torch.promote_types(y.dtype, torch.float64)
    w = lambda x: x.to(wide)
    spans = _spans(y.shape[1], plan)
    ks = [k1]
    for i in range(1, 7):
        yi = y + dtc * fm._stage_acc(i, ks)
        ti = w(tc + TSIT5.c[i] * dtc)
        part = sum(w(yi[:, a:b]) @ w(w1x[:, a:b]).T for a, b in spans)
        h = fm._tanh((part + (ti * w(w1t) + w(b1))).to(y.dtype))
        ks.append(fm._tanh((w(h) @ w(w2h).T + (ti * w(w2t) + w(b2))).to(y.dtype)))
    return (y + dtc * fm._stage_acc(6, ks), ks[6], dtc * fm._err_comb(ks), ks[5],
            y + dtc * fm._stage_acc(5, ks))


def plain_normed_solve_step(t, dt, y, k1, leaves, plan: WalkPlan, rtol, atol):
    """One launch of K1 (``csrc/mlp_step_solve.cuh`` with ``NormedEnd``), the
    normed step, in the kernel's own schedule: K3's six stages on ``plan``
    (``_solve_stages``), each element's three norm terms as
    ``fm._normed_outs`` forms them, and their sums in the kernel's order
    (``_kernel_order_sums``). Returns ``(y_new, k7, err_ssq, num_ssq,
    den_ssq)``. For the tests: the kernel's arithmetic in this order."""
    ks, _ = _solve_stages(t, dt, y, k1, leaves, plan)
    y_new, g6 = y + dt * fm._stage_acc(6, ks), y + dt * fm._stage_acc(5, ks)
    denom = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
    scaled = dt * fm._err_comb(ks) / denom
    dk, dg = ks[6] - ks[5], y_new - g6
    sums = _kernel_order_sums(torch.stack([scaled * scaled, dk * dk, dg * dg]), plan)
    return (y_new, ks[6], *sums)


def _warp_sum(v):
    """``warp_sum`` (``csrc/normed_tsit5.cuh``) over the last axis, 32 lanes:
    the xor shuffle tree, every lane adding its partner's value at offsets
    16, 8, 4, 2, 1; lane 0's result."""
    lanes = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _kernel_order_sums(terms, plan: WalkPlan):
    """The sums over the batch of ``terms`` ``(Q, B, D)`` in the order K1
    takes them: each thread of each tile adds its terms one by one (its
    items ``e = thread + 256 k`` over the tile's 4-row groups of a column,
    ``c = e % C``, ``g = e // C``, the group's four rows, row chunk after
    row chunk; ``solve_finish``), the block sums them by a shuffle tree a
    warp and the warps in order into its slot (``block_sum_to``), and the
    slots are summed by lanes strided over the tiles and a shuffle tree
    (``sum_tiles``). Returns the ``Q`` sums."""
    Q, B, D = terms.shape
    R, C, threads = plan.rows, plan.cols, 32 * _WARPS
    items = C * (R // 4)
    ix = functools.partial(torch.arange, device=terms.device)
    blk = ix(plan.tiles).reshape(-1, 1, 1, 1, 1)
    e = (ix(threads).reshape(1, -1, 1, 1, 1)
         + threads * ix(-(-items // threads)).reshape(1, 1, 1, -1, 1))
    chunk = ix(plan.chunks).reshape(1, 1, -1, 1, 1)
    q = ix(4).reshape(1, 1, 1, 1, -1)
    row = (chunk * plan.row_blocks + blk // plan.col_blocks) * R + 4 * (e // C) + q
    col = (blk % plan.col_blocks) * C + e % C
    flat = torch.where((e < items) & (row < B) & (col < D), row * D + col, B * D)
    padded = torch.cat([terms.reshape(Q, B * D), terms.new_zeros(Q, 1)], 1)
    seq = padded[:, flat.reshape(plan.tiles, threads, -1)]
    acc = terms.new_zeros(seq.shape[:-1])
    for j in range(seq.shape[-1]):
        acc = acc + seq[..., j]
    warps = _warp_sum(acc.reshape(Q, plan.tiles, _WARPS, 32))
    slots = terms.new_zeros(Q, plan.tiles)
    for w in range(_WARPS):
        slots = slots + warps[..., w]
    lanes = terms.new_zeros(Q, 32)
    for part in torch.cat([slots, slots.new_zeros(Q, -plan.tiles % 32)], 1).reshape(
            Q, -1, 32).unbind(1):
        lanes = lanes + part
    return tuple(_warp_sum(lanes))


def plain_lanes_walk_step(t, dt, y, k1, leaves, cts, plan: WalkPlan):
    """One launch of K12 (``csrc/mlp_step_walk.cuh`` with ``LaneSeed``),
    the lane-wise step's backward, in the kernel's own schedule:
    ``plain_tuple_walk_step`` with every row at its own time, ``t`` and
    ``dt`` ``(B,)``; each row's ``ct_t`` and ``ct_dt`` summed over its own
    terms. Returns ``(ct_t, ct_dt, ct_y, ct_k1, (cp2, he, cp1, ye))``,
    ``ct_t`` and ``ct_dt`` ``(B,)``. For the tests: the kernel's arithmetic
    is ``fused_mlp_lanes._lanes_bwd_math``'s in this order."""
    ct_t, ct_dt, *rest = plain_tuple_walk_step(t[:, None], dt[:, None], y, k1, leaves, cts,
                                               plan)
    return (ct_t[:, 0], ct_dt[:, 0], *rest)


def _sum_for(dt):
    """How the walk sums its ct_t and ct_dt terms: over everything for a
    scalar ``dt``, per row (``dim=1``) for a ``(B, 1)`` column."""
    if dt.dim() == 2:
        return lambda x: torch.sum(x, dim=1, keepdim=True)
    return torch.sum


def _walk_stages(t, dt, y, leaves, ks, hs, cks, cp2, cty, ct_dt, seeds, plan: WalkPlan):
    """The seeds of the stage inputs ``seeds`` (stage -> rows) carried into
    ``cty``, ``cks`` and ``ct_dt`` as those stages' ``ct_yi`` carry them,
    then per stage ``i = 6..1`` of the walk: phase A, ``ct_h = cp2_i W2``
    with W2's time column, one partial per column block of ``plan``; the
    reduction, the partials summed in block order, ``ct_pre1 = ct_h (1 -
    h_i^2)`` and the time terms of ``ct_ti``; and phase B, ``ct_yi =
    ct_pre1 W1x`` and the epilogue (``cty``, ``cks[j < i]``, the dt share,
    the ``ye`` rows, ``cp2_{i-1}``). ``cks``: the cotangents of k1..k6,
    ``cp2``: ct_pre2 of stage 6. Returns ``(ct_t, ct_dt, ct_y, ct_k1, (cp2,
    he, cp1, ye))``; at ``(B, 1)`` time columns ``ct_t`` and ``ct_dt`` are
    per row (``_sum_for``)."""
    tab = TSIT5
    W1, _, W2, _ = leaves
    D = y.shape[1]
    H = W1.shape[0]
    total = _sum_for(dt)
    for i, seed in seeds.items():
        ct_dt = ct_dt + total(seed * fm._stage_acc(i, ks))
        for j, c in enumerate(tab.a[i - 1]):
            if c != 0.0:
                cks[j] = cks[j] + (dt * c) * seed
    cty = cty + seeds[6] + seeds[5]
    ct_t = torch.zeros_like(ct_dt)
    spans = _spans(D, plan)
    one = torch.ones_like(y[:, :1])
    rows = {}
    for i in range(6, 0, -1):
        ti = t + tab.c[i] * dt
        # ---- phase A, a partial per column block; the reduction, in block order ----
        ct_h = sum(cp2[:, a:b] @ W2[a:b] for a, b in spans)
        h_i = hs[i - 1]
        ct_pre1 = ct_h[:, :H] * (1.0 - h_i * h_i)
        ct_ti = total(ct_h[:, H:]) + total(ct_pre1 * W1[:, D])
        # ---- phase B ----
        ct_yi = ct_pre1 @ W1[:, :D]
        cty = cty + ct_yi
        acc = fm._stage_acc(i, ks)
        ct_dt = ct_dt + total(ct_yi * acc)
        for j, c in enumerate(tab.a[i - 1]):
            if c != 0.0:
                cks[j] = cks[j] + (dt * c) * ct_yi
        rows[i] = (cp2, torch.cat([h_i, ti * one, one], 1), ct_pre1,
                   torch.cat([y + dt * acc, ti * one, one], 1))
        if i > 1:  # cks[i-1] is final
            cp2 = cks[i - 1] * (1.0 - ks[i - 1] * ks[i - 1])
        ct_t = ct_t + ct_ti
        ct_dt = ct_dt + tab.c[i] * ct_ti
    out = tuple(torch.cat([rows[i][q] for i in range(1, 7)]) for q in range(4))
    return ct_t, ct_dt, cty, cks[0], out


def _rows_through(saveat, t, tdir):
    """The save times at or before ``t`` in the direction ``tdir`` (int32,
    0-d), on ``saveat``'s device."""
    return ((saveat - t) * tdir <= 0).sum().to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def plain_whole_solve_fwd(t0, t1, dt0, y0, f0, leaves, rtol, atol,
                          ctrl: PIController, max_steps: int, *, dynamics="mlp",
                          saveat=None, ys_init=None, cache_residuals=True) -> SolveRecord:
    """Plain version of K3: the trial-step loop over the dynamics' plain
    trial step, with the Hermite writes of ``ode._HermiteSaver``; for
    ``MLPDynamics`` with ``cache_residuals``, each trial step's stage
    residuals from ``fm._reference_normed_sweep_res``."""
    sweep, _ = plain_steps(dynamics, rtol, atol)
    stream = _streams_residuals(dynamics, cache_residuals)
    res_rows = []
    if stream:
        def sweep(t, dt, y, k1, lv):
            outs, res = fm._reference_normed_sweep_res(
                t, dt, y, k1, fm._split_params(*lv), float(rtol), float(atol))
            res_rows.append(res)
            return NormedSweep(*outs)
    k_last = {}
    saver = None
    if saveat is not None:
        saver = _HermiteSaver(saveat, torch.sign(t1 - t0), ys_init, keep=False)

    def on_accept(i, t, dt_eff, t_end, y, f, res):
        k_last[i] = res.k_last
        if saver is not None:
            saver(i, t, dt_eff, t_end, y, f, res)

    y1, rows, accepted, done, hist = _solve_forward(
        sweep, ctrl, max_steps, t0, t1, dt0, y0, f0, tuple(leaves), keep_history=True,
        on_accept=on_accept)
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
    ks = hs = y0.new_zeros((0,))
    if stream:
        ks = y0.new_zeros((max_steps, 6) + tuple(y0.shape))
        hs = y0.new_zeros((max_steps, 6, y0.shape[0], leaves[0].shape[0]))
        for i, (k, h) in enumerate(res_rows):
            ks[i], hs[i] = torch.stack(k[1:]), torch.stack(h)
    if ns:
        hf[ns] = k_last[ns - 1] if accepted[-1] else hf[ns - 1]
        # the loop's final (t, dt, qold): the last step's scalar chain again
        t, dt, qold, e, n, d = hist[-1][:6]
        tdir = torch.sign(t1 - t0)
        remaining = t1 - t
        is_last = (dt - remaining) * tdir >= 0
        t, dt, qold = _post(ctrl, float(y0.numel()), t, torch.where(is_last, remaining, dt),
                            qold, e, n, d, t1, torch.abs(t1 - t0), is_last)[:3]
    else:
        hf[0] = f0
        t, dt, qold = t0, dt0, torch.full_like(t0, ctrl.qoldinit)
    na = sum(accepted)
    final = torch.stack((t, dt, qold)).to(streams.dtype)
    final = torch.cat([final, final.new_tensor([na, ns - na, float(done)])])
    if saveat is None:
        ys = y0.new_zeros((0,) + tuple(y0.shape))
        cursors = torch.zeros(2, dtype=torch.int32)
    else:
        ys = saver.ys if saver.ys is not ys_init else ys_init.clone()
        tdir = torch.sign(t1 - t0)
        cursors = torch.stack((_rows_through(saveat, t0, tdir),
                               _rows_through(saveat, t, tdir)))
    return SolveRecord(y1, hy, hf, streams, final, ys, cursors.to(y0.device), ks, hs)


def plain_whole_solve_bwd(rec: SolveRecord, ns: int, ct_y1, ct_tel, t0, t1,
                          leaves, rtol, atol, ctrl: PIController, *,
                          dynamics="mlp", saveat=None, ct_ys=None, cache_residuals=True):
    """Plain version of K4: the reverse walk over ``rec``'s ``ns`` trial
    steps, ``post_bwd`` for the scalar chain, ``ode.hermite_pullback`` for
    the ``saveat`` rows (cotangent ``ct_ys``) and the dynamics' plain
    reverse for the trial step, fed ``rec``'s stage residuals for
    ``MLPDynamics`` with ``cache_residuals`` (else it recomputes them).
    ``ct_tel`` is ``(4, S)``, the cotangents of the telemetry streams ``t,
    dt, eest, eigen_est``. Returns ``(ct_t0, ct_t1, ct_dt0, ct_y0, ct_f0,
    ct_ys_init, *ct_leaves)``."""
    _, sweep_bwd = plain_steps(dynamics, rtol, atol)
    stream = _streams_residuals(dynamics, cache_residuals)
    if stream:
        _check_residuals(rec, ns)
    tdir = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)
    count = float(rec.y1.numel())
    zero = torch.zeros_like(t0)
    carry = AdjointCarry(zero, zero, zero, ct_y1, torch.zeros_like(ct_y1),
                         [torch.zeros_like(x) for x in leaves], zero, zero)
    if saveat is None:
        ct_ys = torch.zeros_like(rec.ys)
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
        interp = None
        if saveat is not None and accepted[i]:
            interp, ct_ys = hermite_pullback(
                saveat, tdir, t1, is_last,
                (t_i, dt_eff, rec.hy[i], rec.hy[i + 1], rec.hf[i], rec.hf[i + 1]), ct_ys)
        step_bwd = sweep_bwd
        if stream:
            def step_bwd(t, dt, y, k1, lv, cts, _i=i):
                res = ([k1, *rec.ks[_i].unbind(0)], rec.hs[_i].unbind(0))
                return fm._normed_bwd_math(t, dt, y, k1, fm._split_params(*lv), tuple(cts),
                                           float(rtol), float(atol), res=res)
        carry = adjoint_step(step_bwd, leaves, (t_i, dt_eff, rec.hy[i], rec.hf[i]),
                             accepted[i], is_last, dp, ct_tel[1, i], carry, interp)
    out = carry.finish(tdir)
    return (*out[:5], ct_ys, *out[5:])


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, kernel for CUDA tensors.
# ---------------------------------------------------------------------------


def _ctrl_args(ctrl: PIController):
    return [float(x) for x in (ctrl.beta1, ctrl.beta2, ctrl.qmin, ctrl.qmax,
                               ctrl.gamma, ctrl.qoldinit, ctrl.qsteady_max)]


def _check_dims(dynamics, y, k1, leaves):
    """``(B, D, H, depth, kinetic)`` after the step kernels' checks of the
    rows and leaves (device, float32, shape, contiguity): depth is
    AlternatingMLP's (1 for the others), kinetic CSL's flag (0 for the
    others), and for CSL ``D`` is the augmented state's width."""
    if dynamics == "mlp":
        return (*fm._check_cuda_args(y, k1, leaves), 1, 0)
    if dynamics == "altmlp":
        B, D, H, depth = fg._check_cuda_args(y, k1, leaves)
        fg._library(depth)
        return B, D, H, depth, 0
    if dynamics == "csl":
        B, A, H, kinetic = fc._check_cuda_args(y, k1, leaves)
        return B, A, H, 1, kinetic
    raise ValueError(f"dynamics must be one of {DYNAMICS}, got {dynamics!r}")


def _check_residuals(rec, ns):
    """A streamed backward needs the forward's stage residuals: it never
    falls back to the replay."""
    if rec.ks.dim() != 4 or rec.hs.dim() != 4 or rec.ks.shape[0] < ns:
        raise ValueError("the record holds no stage residuals for its trial steps: "
                         "run the forward with cache_residuals=True, or the backward "
                         "with cache_residuals=False")


def _check_tensor(name, x, shape, like, dtype=torch.float32):
    if (x.device != like.device or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor on {like.device}")


def _opt_ptr(x):
    return None if x is None else fm._ptr(x)


def _slot_rows(lib, dynamics, bwd=False):
    """Rows of one slot of the per-trial-step partials of K3 (the norm sums)
    and, with ``bwd``, of K4 ((ct_t, ct_dt)) for AlternatingMLP and CSL
    (MLPDynamics' kernels run on ``walk_plan``'s tiles). A backward slot is
    a tile: K4's for AlternatingMLP (K8's reverse body,
    ``regnde_altmlp_bwd_rows``), K4-CSL's (K8-CSL's, 8 rows); the forwards'
    tiles write one slot a 2-row sub-tile: K3's for AlternatingMLP (K7's
    forward body, ``regnde_altmlp_slot_rows``) and K3-CSL's (K7-CSL's)."""
    if dynamics == "altmlp":
        return lib.regnde_altmlp_bwd_rows() if bwd else lib.regnde_altmlp_slot_rows()
    return lib.regnde_csl_bwd_rows() if bwd else lib.regnde_csl_slot_rows()


def _cuda_walk_plan(lib, B, D, H, dev, lanes=False):
    """``walk_plan`` for the card (K12's with ``lanes``), held to the
    kernels' own constants."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = walk_plan(B, D, H, sms, state=LANE_STATE) if lanes else walk_plan(B, D, H, sms)
    _check_walk_sizes(lib, plan, H, lanes)
    return plan


@functools.lru_cache(maxsize=64)
def _check_walk_sizes(lib, plan, H, lanes):
    """Raises unless ``plan``'s sizes are the library's (once a plan: a
    check that passed is not made again); with ``lanes`` K12's and K11's."""
    smem = lib.regnde_lanes_walk_smem_bytes if lanes else lib.regnde_walk_smem_bytes
    solve = lib.regnde_lanes_solve_smem_bytes if lanes else lib.regnde_solve_smem_bytes
    if (lib.regnde_walk_col_align() != WALK_COL_ALIGN
            or lib.regnde_walk_max_tile() != WALK_MAX_TILE
            or smem(plan.rows, plan.cols, H) != plan.smem_bytes
            or solve(plan.rows, plan.cols, H)
            != solve_smem_bytes(plan.rows, plan.cols, H, lanes)):
        raise RuntimeError("walk_plan's sizes disagree with csrc/mlp_walk.cuh's or "
                           "csrc/mlp_solve.cuh's")


def _cuda_solve_scratch(lib, plan, H, dev, lanes=False):
    """K3's, K13's and K1's scratch for ``plan`` (partials, hidden rows,
    padded weights, slots), or with ``lanes`` K11's (the same in doubles),
    sized by the kernel."""
    floats = lib.regnde_lanes_solve_scratch_floats if lanes else lib.regnde_solve_scratch_floats
    return torch.empty(floats(plan.rows, plan.cols, plan.row_blocks, plan.col_blocks, H),
                       device=dev)


def _cuda_walk_scratch(lib, plan, B, D, H, dev, replay):
    """The walk's scratch for ``plan`` (K4<MlpDyn>, K2, K14 and K12): phase A's
    partials ``psum``, the row blocks' ct_pre1 ``ctp1g``, the weights padded
    for its 16-byte copies ``w2p`` and ``w1p`` (the kernel fills them), and
    with ``replay`` the replay's stage residuals of one trial step and K3's
    scratch (else three None)."""
    hpp, width = _round_up(H + 1, WALK_COL_ALIGN), plan.col_blocks * plan.cols
    walk = (torch.empty((plan.tiles, plan.rows, hpp), device=dev),
            torch.empty((plan.row_blocks, H, plan.rows), device=dev),
            torch.empty((width, hpp), device=dev), torch.empty((H, width), device=dev))
    step = ((torch.empty((6, B, D), device=dev), torch.empty((6, B, H), device=dev),
             _cuda_solve_scratch(lib, plan, H, dev))
            if replay else (None, None, None))
    return walk, step


def _cuda_whole_solve_fwd(t0, t1, dt0, y0, f0, leaves, rtol, atol, ctrl,
                          max_steps, dynamics, saveat, ys_init, cache_residuals):
    from regneuralde_tpu_torch.ops import _cuda

    B, D, H, depth, kinetic = _check_dims(dynamics, y0, f0, leaves)
    if max_steps < 1:
        raise ValueError(f"max_steps must be positive, got {max_steps}")
    n_save = 0 if saveat is None else saveat.shape[0]
    dev = y0.device
    if n_save:
        _check_tensor("saveat", saveat, (n_save,), y0)
        _check_tensor("ys_init", ys_init, (n_save, B, D), y0)
        ys = ys_init.clone()
        cursors = torch.stack((_rows_through(saveat, t0, torch.sign(t1 - t0)),
                               torch.zeros((), dtype=torch.int32, device=dev)))
    else:
        ys = y0.new_zeros((0, B, D))
        cursors = torch.zeros(2, dtype=torch.int32, device=dev)
    save_ptrs = tuple(map(fm._ptr, (saveat, cursors, ys))) if n_save else (None,) * 3
    lib = _cuda.library()
    ptr = fm._ptr
    scalars = torch.stack([fm._scalar_f32(x, y0) for x in (t0, t1, dt0)])
    y1 = torch.empty_like(y0)
    hy = torch.empty((max_steps + 1, B, D), device=dev)
    hf = torch.empty_like(hy)
    streams = torch.zeros((N_STREAMS, max_steps), device=dev)
    final = torch.empty(6, device=dev)
    # the stage residuals at max_steps rows: the step count is known only
    # after the solve
    ks = hs = y0.new_empty((0,))
    res = (None, None)
    if _streams_residuals(dynamics, cache_residuals):
        ks = torch.empty((max_steps, 6, B, D), device=dev)
        hs = torch.empty((max_steps, 6, B, H), device=dev)
        res = (ks, hs)
    rows = (ptr(y1), ptr(hy), ptr(hf), ptr(streams), ptr(final))
    tail = (float(rtol), float(atol), *_ctrl_args(ctrl),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if dynamics == "mlp":
        plan = _cuda_walk_plan(lib, B, D, H, dev)
        scratch = _cuda_solve_scratch(lib, plan, H, dev)
        code = lib.regnde_whole_solve_fwd(
            ptr(scalars), ptr(y0), ptr(f0), *map(ptr, leaves), *save_ptrs,
            *map(_opt_ptr, res), *rows, ptr(scratch), B, D, H, max_steps, n_save,
            plan.rows, plan.cols, plan.row_blocks, plan.col_blocks, plan.chunks, *tail)
        name = "whole_solve_fwd"
    else:
        if dynamics == "csl":
            fc.check_fwd_plan(lib, D, D - 1 - 2 * kinetic, H, kinetic)
        else:
            fg.check_fwd_plan(lib, D, H, depth)
        slot = _slot_rows(lib, dynamics)
        partials = torch.empty((2, (B + slot - 1) // slot, 3), device=dev)
        head = (ptr(scalars), ptr(y0), ptr(f0),
                ctypes.cast(fg._leaf_pointers(leaves), ctypes.c_void_p))
        rest = (*save_ptrs, *rows, ptr(partials), B, D, H, max_steps, n_save, *tail)
        if dynamics == "altmlp":
            code = lib.regnde_whole_solve_altmlp_fwd(*head, depth, *rest)
        else:
            code = lib.regnde_whole_solve_csl_fwd(*head, kinetic, *rest)
        name = f"whole_solve_{dynamics}_fwd"
    _cuda.check(code, "whole-solve forward kernel")
    LAUNCHES[name] += 1
    return SolveRecord(y1, hy, hf, streams, final, ys, cursors, ks, hs)


def _cuda_whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, rtol, atol,
                          ctrl, dynamics, saveat, ct_ys, cache_residuals):
    from regneuralde_tpu_torch.ops import _cuda

    y1 = rec.y1
    B, D, H, depth, kinetic = _check_dims(dynamics, y1, ct_y1, leaves)
    S = rec.streams.shape[1]
    n_save = 0 if saveat is None else saveat.shape[0]
    for name, x, shape in (("ct_tel", ct_tel, (4, S)), ("hy", rec.hy, (S + 1, B, D)),
                           ("hf", rec.hf, (S + 1, B, D)),
                           ("streams", rec.streams, (N_STREAMS, S))):
        _check_tensor(name, x, shape, y1)
    if not 0 <= ns <= S:
        raise ValueError(f"ns must lie in [0, {S}], got {ns}")
    res = (None, None)
    if _streams_residuals(dynamics, cache_residuals):
        _check_residuals(rec, ns)
        _check_tensor("ks", rec.ks, (S, 6, B, D), y1)
        _check_tensor("hs", rec.hs, (S, 6, B, H), y1)
        res = (rec.ks, rec.hs)
    dev = y1.device
    hdy = hdf = None
    if n_save:
        _check_tensor("saveat", saveat, (n_save,), y1)
        _check_tensor("ct_ys", ct_ys, (n_save, B, D), y1)
        _check_tensor("cursors", rec.cursors, (2,), y1, torch.int32)
        ct_ys = ct_ys.clone()
        hdy, hdf = torch.empty_like(y1), torch.empty_like(y1)
    else:
        ct_ys = y1.new_zeros((0, B, D))
    save_ptrs = (tuple(map(fm._ptr, (saveat, rec.cursors, ct_ys))) if n_save
                 else (None,) * 3)
    lib = _cuda.library()
    ptr = fm._ptr
    scalars = torch.stack([fm._scalar_f32(x, y1) for x in (t0, t1)])
    ct_y = ct_y1.clone()
    ct_f = torch.zeros_like(ct_y)
    ct_scalars = torch.empty(3, device=dev)
    head = (ptr(scalars), ptr(rec.streams), ptr(rec.hy), ptr(rec.hf))
    mid = (ptr(ct_tel), ptr(ct_y), ptr(ct_f))
    dims = (ns, B, D, H, S, n_save)
    tail = (float(rtol), float(atol), *_ctrl_args(ctrl),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if dynamics == "mlp":
        replay = res[0] is None
        plan = _cuda_walk_plan(lib, B, D, H, dev)
        slots = torch.empty((2, plan.tiles, 4), device=dev)
        (psum, ctp1g, *wpad), step = _cuda_walk_scratch(lib, plan, B, D, H, dev, replay)
        ct_leaves = [torch.empty_like(x) for x in leaves]
        # the weight-cotangent rows of every trial step, summed after the walk
        K = 6 * B * ns
        wrows = [torch.empty((K, w), device=dev) for w in (D, H + 2, H, D + 2)]
        wpart, chunk_rows, wfloats = wc.cuda_scratch(K, D, H, dev)
        code = lib.regnde_whole_solve_bwd(
            *head, *map(ptr, leaves), *map(_opt_ptr, res), *save_ptrs, *mid,
            *map(ptr, ct_leaves), ptr(ct_scalars), ptr(slots), ptr(psum), ptr(ctp1g),
            _opt_ptr(hdy),
            _opt_ptr(hdf), *map(_opt_ptr, step), *map(ptr, wpad), *map(ptr, wrows), ptr(wpart),
            *dims,
            plan.rows, plan.cols, plan.row_blocks, plan.col_blocks, plan.chunks,
            chunk_rows, wfloats, *tail)
        name = "whole_solve_bwd"
    else:
        rows = _slot_rows(lib, dynamics, bwd=True)
        ntiles = (B + rows - 1) // rows
        partials = torch.empty((2, ntiles, 4), device=dev)
        # the leaves with a cotangent: CSL's probe has none
        params = leaves if dynamics == "altmlp" else leaves[:fc.N_PARAMS]
        n_leaf = sum(x.numel() for x in params)
        out = torch.empty(n_leaf, device=dev)
        if dynamics == "altmlp":  # a slot a block, then each block's records (AltDyn)
            fg.altmlp_bwd_plan(B, D, H, depth)
            slots = fg._altmlp_walk_scratch(lib, B, D, H, depth, dev,
                                            torch.cuda.current_stream(dev).cuda_stream)
        else:  # a slot a block, then each block's activation records (CslDyn)
            plan = fc.check_bwd_plan(lib, D, D - 1 - 2 * kinetic, H, kinetic)
            slots = torch.empty(fc._pad4(ntiles * n_leaf) + ntiles * plan.record_floats,
                                device=dev)
        lptrs = ctypes.cast(fg._leaf_pointers(leaves), ctypes.c_void_p)
        rest = (*save_ptrs, *mid, ptr(out), ptr(ct_scalars), ptr(partials),
                _opt_ptr(hdy), _opt_ptr(hdf), ptr(slots), *dims, *tail)
        if dynamics == "altmlp":
            code = lib.regnde_whole_solve_altmlp_bwd(*head, lptrs, depth, *rest)
        else:
            code = lib.regnde_whole_solve_csl_bwd(*head, lptrs, kinetic, *rest)
        ct_leaves, off = [], 0
        for x in params:
            ct_leaves.append(out[off:off + x.numel()].view(x.shape))
            off += x.numel()
        ct_leaves += [torch.zeros_like(x) for x in leaves[len(params):]]
        name = f"whole_solve_{dynamics}_bwd"
    _cuda.check(code, "whole-solve backward kernel")
    LAUNCHES[name] += 1
    if dynamics == "mlp":
        wc.count_launch()
    return (ct_scalars[0], ct_scalars[1], ct_scalars[2], ct_y, ct_f, ct_ys, *ct_leaves)


def whole_solve_fwd(t0, t1, dt0, y0, f0, leaves: Sequence[torch.Tensor], rtol,
                    atol, ctrl: PIController, max_steps: int, *, dynamics="mlp",
                    saveat=None, ys_init=None, cache_residuals=True) -> SolveRecord:
    """K3 or its plain version: the whole forward solve of ``dynamics``
    (``"mlp"``, ``"altmlp"`` or ``"csl"``), writing the ``saveat`` rows over
    ``ys_init`` (by default ``ode.saveat_rows``'s) and, for ``"mlp"`` with
    ``cache_residuals``, the stage residuals ``ks``/``hs``."""
    if saveat is not None and ys_init is None:
        saveat, ys_init = saveat_rows(saveat, t0, t1, y0)
    args = (t0, t1, dt0, y0, f0, tuple(leaves), rtol, atol, ctrl, max_steps)
    if y0.device.type == "cuda":
        return _cuda_whole_solve_fwd(*args, dynamics, saveat, ys_init, cache_residuals)
    if y0.device.type == "cpu":
        return plain_whole_solve_fwd(*args, dynamics=dynamics, saveat=saveat,
                                     ys_init=ys_init, cache_residuals=cache_residuals)
    raise RuntimeError(f"no whole-solve forward for device {y0.device}")


def whole_solve_bwd(rec: SolveRecord, ns: int, ct_y1, ct_tel, t0, t1,
                    leaves: Sequence[torch.Tensor], rtol, atol,
                    ctrl: PIController, *, dynamics="mlp", saveat=None, ct_ys=None,
                    cache_residuals=True):
    """K4 or its plain version: ``(ct_t0, ct_t1, ct_dt0, ct_y0, ct_f0,
    ct_ys_init, *ct_leaves)``; ``ct_ys`` is the cotangent of the
    ``saveat`` rows. For ``"mlp"`` with ``cache_residuals`` it reads
    ``rec``'s stage residuals (and raises if the record has none);
    without, it re-runs each trial step's stage sweep."""
    args = (rec, ns, ct_y1, ct_tel, t0, t1, tuple(leaves), rtol, atol, ctrl)
    if ct_y1.device.type == "cuda":
        return _cuda_whole_solve_bwd(*args, dynamics, saveat, ct_ys, cache_residuals)
    if ct_y1.device.type == "cpu":
        return plain_whole_solve_bwd(*args, dynamics=dynamics, saveat=saveat,
                                     ct_ys=ct_ys, cache_residuals=cache_residuals)
    raise RuntimeError(f"no whole-solve backward for device {ct_y1.device}")


# ---------------------------------------------------------------------------
# The differentiable solve and its odeint-compatible front end.
# ---------------------------------------------------------------------------


class WholeSolveFn(torch.autograd.Function):
    """The whole solve with K4 as its gradient. Inputs ``t0, t1, dt_init,
    y0, f0_init``, the ``saveat`` rows' initial values ``ys_init`` and the
    leaves; outputs those of ``ode.FastAdjointSolve``: ``y1``, the
    ``saveat`` rows ``ys``, the telemetry streams ``t, dt, eest,
    eigen_est``, and, not differentiable, the accept and live masks and
    ``(naccept, nreject, done)``."""

    @staticmethod
    def forward(ctx, dynamics, ctrl, max_steps, rtol, atol, saveat, t0, t1,
                dt_init, y0, f0_init, ys_init, *leaves):
        unsorted = None
        if saveat is not None:
            unsorted = ((saveat[1:] - saveat[:-1]) * torch.sign(t1 - t0) < 0).any()
        rec = whole_solve_fwd(t0, t1, dt_init, y0, f0_init, leaves, rtol, atol,
                              ctrl, max_steps, dynamics=dynamics, saveat=saveat,
                              ys_init=ys_init)
        # the one host sync of the solve: the step counts size the backward
        flags = rec.final[3:]
        if unsorted is not None:
            flags = torch.cat([flags, unsorted.to(flags.dtype).reshape(1)])
        na, nr, done, *bad = (int(v) for v in flags.tolist())
        if any(bad):
            raise ValueError("the whole solve takes saveat monotone in the "
                             "direction of integration; sort it or use fused='step'")
        st = rec.streams
        accepted = st[ST_ACC] > 0.5
        live = torch.arange(max_steps, device=st.device) < na + nr
        counts = torch.tensor([na, nr, done])
        ctx.mark_non_differentiable(accepted, live, counts)
        ctx.rec, ctx.ns = rec, na + nr
        ctx.args = (dynamics, ctrl, rtol, atol, saveat)
        ctx.save_for_backward(t0, t1, *leaves)
        return (rec.y1, rec.ys, st[TEL_T].clone(), st[TEL_DT].clone(),
                st[TEL_EEST].clone(), st[TEL_EIGEN].clone(), accepted, live, counts)

    @staticmethod
    def backward(ctx, ct_y1, ct_ys, ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g, *_):
        t0, t1, *leaves = ctx.saved_tensors
        dynamics, ctrl, rtol, atol, saveat = ctx.args
        rec = ctx.rec
        S = rec.streams.shape[1]
        ct_tel = torch.stack([
            rec.streams.new_zeros(S) if c is None else c.to(rec.streams.dtype)
            for c in (ct_tel_t, ct_tel_dt, ct_tel_e, ct_tel_g)])
        ct_y1 = torch.zeros_like(rec.y1) if ct_y1 is None else ct_y1.contiguous()
        ct_ys = torch.zeros_like(rec.ys) if ct_ys is None else ct_ys.contiguous()
        grads = whole_solve_bwd(rec, ctx.ns, ct_y1, ct_tel, t0, t1, leaves, rtol,
                                atol, ctrl, dynamics=dynamics, saveat=saveat,
                                ct_ys=ct_ys)
        ctx.rec = None
        ct_t0, ct_t1, ct_dt0 = (g.to(t0.dtype).reshape(t0.shape) for g in grads[:3])
        return (None,) * 6 + (ct_t0, ct_t1, ct_dt0, *grads[3:])


def whole_solve_odeint(func: Callable, y0: torch.Tensor, t0, t1, leaves, *,
                       rtol: float, atol: float, max_steps: int, dynamics: str = "mlp",
                       saveat=None, controller: Optional[PIController] = None
                       ) -> ODESolution:
    """Integrate ``dynamics`` (``"mlp"``: ``MLPDynamics`` with leaves ``(W1,
    b1, W2, b2)``; ``"altmlp"``: ``AlternatingMLP`` with its
    ``parameters()``; ``"csl"``: FFJORD's augmented ``CSLDynamics``, its
    ``parameters()`` and the probe) from ``t0`` to ``t1`` in one forward launch and one
    backward launch.

    ``func(t, y, leaves)`` is the model-level dynamics, used for
    ``odeint``'s prologue (``f(t0, y0)`` and the initial step), so the
    solution, its NFE (``2 + 6 * trial steps``), its telemetry and its
    ``saveat`` rows ``ys`` (stamps at or before ``t0`` hold ``y0``) are
    those ``ops.ode.odeint`` returns."""
    if dynamics not in DYNAMICS:
        raise ValueError(f"dynamics must be one of {DYNAMICS}, got {dynamics!r}")
    ctrl = controller or PIController.for_order(TSIT5.order)
    leaves = tuple(leaves)
    t0, t1, f_init, dt_init = solve_prologue(func, y0, t0, t1, leaves, rtol, atol)
    saveat, ys_init = saveat_rows(saveat, t0, t1, y0)
    (y1, ys, tel_t, tel_dt, tel_e, tel_g, acc, live, counts) = WholeSolveFn.apply(
        dynamics, ctrl, max_steps, float(rtol), float(atol), saveat, t0, t1, dt_init,
        y0, f_init, ys_init, *leaves)
    naccept, nreject, done = counts.tolist()
    return ODESolution(y1=y1, stats=solve_stats(naccept, nreject, done),
                       telemetry=StepTelemetry(tel_t, tel_dt, tel_e, tel_g, acc, live),
                       ys=None if saveat is None else ys, ts=saveat)
