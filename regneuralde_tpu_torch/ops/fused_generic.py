"""Normed Tsit5 trial step of ``AlternatingMLP``: plain PyTorch and CUDA kernels.

Counterpart of ``regneuralde_tpu/ops/pallas_generic.py`` for the latent
ODE's dynamics, ``AlternatingMLP``: tanh, then ``depth`` pairs of
``up_i = Linear(D, H)``, ``down_i = Linear(H, D)``, each followed by tanh.
One trial step runs the six Tsit5 stages and reduces the error and
stiffness norms to three sums of squares, as ``ops.fused_mlp`` does for
``MLPDynamics``.

The leaves are the module's ``parameters()`` in order, ``(up_0.weight,
up_0.bias, down_0.weight, down_0.bias, up_1.weight, ...)``, in the
``nn.Linear`` layout (weights ``(out, in)``).

Each direction has a plain version and a CUDA kernel
(``csrc/altmlp_tsit5.cu``): K7's plain version is
``plain_altmlp_normed_sweep`` (the algebra of ``_stage_algebra``), K8's is
``_altmlp_bwd_math``, the hand reverse chain the kernel runs (the JAX
kernel traces ``jax.vjp`` instead). The wrappers ``altmlp_normed_sweep``
and ``altmlp_normed_sweep_bwd`` take the plain version for tensors on the
CPU, launch the kernel for tensors on a CUDA device, and raise otherwise.
K7 and K3 for AlternatingMLP run one forward tile body
(``csrc/altmlp_tsit5.cuh`` ``altmlp_forward_tile``): its sizes are
``altmlp_fwd_plan``, its order of sums on the CPU ``plain_altmlp_fwd_tiles``.
K8 and K4 run one reverse tile body (``altmlp_reverse_tile``): its sizes are
``altmlp_bwd_plan``, its order of sums on the CPU ``plain_altmlp_bwd_tiles``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

from regneuralde_tpu_torch.ops.fused_mlp import _ptr, _scalar_f32, _stage_acc
from regneuralde_tpu_torch.ops.ode import NormedSweep, _max_grad, normed_terms, plain_normed_sweep
from regneuralde_tpu_torch.ops.tableaus import TSIT5

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"altmlp_tsit5_fwd": 0, "altmlp_tsit5_bwd": 0}

# The forward tile body's constants (``csrc/altmlp_tsit5.cuh``): rows a
# tile, rows a norm-sum slot, the most terms of one lane's share of a sum.
ALT_FWD_ROWS = 2
ALT_SLOT_ROWS = 2
ALT_FWD_CHAIN = 7
# The reverse tile body's: rows a tile, the most terms of one lane's share
# of a sum, the layers whose cotangents a thread holds in registers; a
# block's threads and the shared memory it may take on the H100.
ALT_BWD_ROWS = 2
ALT_CHAIN = 7
ALT_REG_LAYERS = 8
_THREADS = 256
SMEM_LIMIT = 232_448


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# AlternatingMLP leaves.
# ---------------------------------------------------------------------------


def alternating_mlp_leaves(dynamics) -> List[torch.Tensor]:
    """The leaves of a ``models.basic.AlternatingMLP`` in the kernels'
    order (its ``parameters()``)."""
    leaves = []
    for i in range(dynamics.depth):
        for name in (f"up_{i}", f"down_{i}"):
            layer = getattr(dynamics, name)
            leaves += [layer.weight, layer.bias]
    return leaves


def _dense_tanh(h, W, b):
    """``tanh(h W^T + b)`` with the affine map summed in float64 and rounded
    once to ``h``'s type: the correctly rounded sum (up to a rare double
    rounding), whatever the summation order. K7/K8 sum the same way, so
    kernel and plain version agree bitwise on every stage value, and the
    solver's decisions agree too where the error estimate sits at its
    float32 rounding floor. ``torch.tanh`` is the counterpart of the JAX
    module's ``jnp.tanh``."""
    acc = torch.addmm(b.to(torch.float64), h.to(torch.float64), W.to(torch.float64).T)
    return torch.tanh(acc.to(h.dtype))


def alternating_mlp_apply(depth: int) -> Callable:
    """``f(t, y, leaves)`` of AlternatingMLP over its leaves (``t`` unused)."""

    def apply_fn(t, y, leaves):
        h = torch.tanh(y)
        for j in range(2 * depth):
            h = _dense_tanh(h, leaves[2 * j], leaves[2 * j + 1])
        return h

    return apply_fn


def alternating_mlp_unflatten_cts(dynamics, d_leaves):
    """Cotangents of the leaves by parameter name (``up_0.weight``, ...)."""
    names = [f"{layer}_{i}.{p}" for i in range(dynamics.depth)
             for layer in ("up", "down") for p in ("weight", "bias")]
    return dict(zip(names, d_leaves))


def _depth(leaves) -> int:
    if len(leaves) % 4 or not leaves:
        raise ValueError(f"AlternatingMLP has 4 leaves a depth level, got {len(leaves)}")
    return len(leaves) // 4


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def plain_altmlp_normed_sweep(t, dt, y, k1, leaves, rtol, atol) -> NormedSweep:
    """Plain version of K7: ``(y_new, k7, err_ssq, num_ssq, den_ssq)``, the
    algebra of ``pallas_generic._stage_algebra`` over AlternatingMLP."""
    return plain_normed_sweep(alternating_mlp_apply(_depth(leaves)), t, dt, y, k1,
                              tuple(leaves), float(rtol), float(atol))


def _activations(y_i, leaves):
    """The nine (for depth 4) activations of one stage: ``h0 = tanh(y_i)``
    and each layer's output; the last is the stage derivative."""
    acts = [torch.tanh(y_i)]
    for j in range(len(leaves) // 2):
        acts.append(_dense_tanh(acts[-1], leaves[2 * j], leaves[2 * j + 1]))
    return acts


def _split(n, chain=ALT_CHAIN):
    """Lanes of the kernel that share one sum of ``n`` terms, at most
    ``chain`` a lane (``1 << alt_split_lg(n)``; the forward's
    ``alt_fwd_split_lg`` with ``ALT_FWD_CHAIN``)."""
    s = 1
    while s < 32 and -(-n // s) > chain:
        s *= 2
    return s


def _split_matmul(v, W):
    """``v @ W`` with the sum over ``v``'s columns split as the reverse body
    splits it: lane ``s`` of ``S`` sums the terms ``s, s + S, ...``, and a
    butterfly adds the lanes' partials pairwise."""
    S = _split(v.shape[1])
    parts = [v[:, s::S] @ W[s::S] for s in range(S)]
    while len(parts) > 1:
        parts = [parts[j] + parts[j + 1] for j in range(0, len(parts), 2)]
    return parts[0]


def _split_dense_tanh(h, W, b):
    """``_dense_tanh`` in the forward body's order of sums
    (``alt_fwd_rows``): lane ``s`` of the ``S`` sharing an output's sum
    adds, in float64 from the bias (lane 0) or zero, ``h[:, k] W[o, k]``
    for ``k = s, s + S, ...`` in that order; a butterfly adds the lanes'
    partials pairwise; the sum is rounded once to ``h``'s type. In float32
    each product is exact in float64 (24-bit by 24-bit mantissas), so each
    addition is the kernel's FMA."""
    x, w = h.to(torch.float64), W.to(torch.float64)
    K = x.shape[1]
    S = _split(K, ALT_FWD_CHAIN)
    parts = []
    for s in range(S):
        acc = b.to(torch.float64).expand(x.shape[0], -1) if s == 0 else x.new_zeros(
            x.shape[0], w.shape[0])
        for k in range(s, K, S):
            acc = acc + x[:, k, None] * w[None, :, k]
        parts.append(acc)
    while len(parts) > 1:
        parts = [parts[j] + parts[j + 1] for j in range(0, len(parts), 2)]
    return torch.tanh(parts[0].to(h.dtype))


def _split_apply(depth: int) -> Callable:
    """``alternating_mlp_apply`` with each affine map in the forward body's
    order of sums (``_split_dense_tanh``)."""

    def apply_fn(t, y, leaves):
        h = torch.tanh(y)
        for j in range(2 * depth):
            h = _split_dense_tanh(h, leaves[2 * j], leaves[2 * j + 1])
        return h

    return apply_fn


def plain_altmlp_fwd_tiles(t, dt, y, k1, leaves, rtol, atol) -> NormedSweep:
    """K7 (the forward tile body) in its own order of sums: the rows through
    the kernel's split float64 sums (``_split_apply``; the plain version's
    rows bitwise but where a float64 sum lies within its rounding error of
    a float32 tie), the per-element terms as ``ode.normed_terms`` forms
    them, and the three sums slot by slot of ``ALT_SLOT_ROWS`` rows, then
    over the slots, as the kernel sums them (``fused_csl.csl_slot_order_
    sums``; where a thread takes more than one element of a slot, 2 D >
    256, the kernel contracts its running sum's update into an FMA, which
    this does not mirror). For the tests: on the card K7's rows and sums
    equal these bitwise."""
    from regneuralde_tpu_torch.ops.fused_csl import csl_slot_order_sums

    y_new, k7, *terms = normed_terms(_split_apply(_depth(leaves)), t, dt, y, k1, tuple(leaves),
                                     float(rtol), float(atol))
    return NormedSweep(y_new, k7, *csl_slot_order_sums(terms, ALT_SLOT_ROWS))


def _altmlp_reverse(dt, y, k1, leaves, cts, rtol, atol, tiled):
    """The hand reverse chain of the normed step over ``y``'s rows: the
    stage recompute keeps every stage's activations, then the stages are
    walked in reverse through each layer's ``tanh' = 1 - tanh^2``. Returns
    ``(ct_dt, ct_y, ct_k1, ct_leaves)``. With ``tiled``, in the order of the
    reverse tile body on one tile: each weight and bias cotangent takes the
    rows one by one, stage after stage (6 to 1); each input cotangent's sum
    is split as ``_split_matmul`` splits it; ct_dt's terms (each rounded to
    ``y``'s type) are summed in float64."""
    tab = TSIT5
    leaves = tuple(leaves)
    cyn, ck7, c_err, c_num, c_den = cts
    total = (lambda x: torch.sum(x.double())) if tiled else torch.sum

    ks, acts = [k1], []
    for i in range(1, 7):
        a = _activations(y + dt * _stage_acc(i, ks), leaves)
        ks.append(a[-1])
        acts.append(a)
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
    # a tie of max(|y|, |y_new|) splits the cotangent in half, as autograd
    # and jax.vjp do
    to_y = _max_grad(ay, an, cm) * torch.sign(y)
    to_ynew = _max_grad(an, ay, cm) * torch.sign(y_new)
    d_k7 = c_num * 2.0 * (ks[6] - ks[5])
    d_ynew = c_den * 2.0 * (y_new - g6)

    ct_ks = [tab.btilde[j] * (dt * cerr) for j in range(7)]
    ct_ks[6] = ct_ks[6] + ck7 + d_k7
    ct_ks[5] = ct_ks[5] - d_k7
    seeds = {6: cyn + d_ynew + to_ynew, 5: -d_ynew}

    ct_dt = total(cerr * s_comb)
    ct_y = to_y
    ct_leaves = [torch.zeros_like(x) for x in leaves]
    for i in range(6, 0, -1):
        a = acts[i - 1]
        ct_h = ct_ks[i]
        for j in range(len(leaves) // 2 - 1, -1, -1):
            ct_pre = ct_h * (1.0 - a[j + 1] * a[j + 1])
            if tiled:
                for r in range(ct_pre.shape[0]):
                    ct_leaves[2 * j] = ct_leaves[2 * j] + ct_pre[r, :, None] * a[j][r, None, :]
                    ct_leaves[2 * j + 1] = ct_leaves[2 * j + 1] + ct_pre[r]
                ct_h = _split_matmul(ct_pre, leaves[2 * j])
            else:
                ct_leaves[2 * j] = ct_leaves[2 * j] + ct_pre.T @ a[j]
                ct_leaves[2 * j + 1] = ct_leaves[2 * j + 1] + torch.sum(ct_pre, dim=0)
                ct_h = ct_pre @ leaves[2 * j]
        ct_yi = ct_h * (1.0 - a[0] * a[0])
        if i in seeds:
            ct_yi = ct_yi + seeds[i]
        ct_y = ct_y + ct_yi
        ct_dt = ct_dt + total(ct_yi * _stage_acc(i, ks))
        for j, c in enumerate(tab.a[i - 1]):
            if c != 0.0:
                ct_ks[j] = ct_ks[j] + (dt * c) * ct_yi
    return ct_dt, ct_y, ct_ks[0], ct_leaves


def _altmlp_bwd_math(t, dt, y, k1, leaves, cts, rtol, atol):
    """Plain version of K8: the hand reverse chain of the normed step
    (``_altmlp_reverse`` over the whole batch).

    Maps ``cts = (ct_y_new, ct_k7, ct_err_ssq, ct_num_ssq, ct_den_ssq)`` to
    ``(ct_t, ct_dt, ct_y, ct_k1, ct_leaves)``; ``ct_t`` is zero (the
    dynamics ignore ``t``). The kernel's chain (``csrc/altmlp_tsit5.cuh``
    ``altmlp_reverse_tile``) in its order of sums is
    ``plain_altmlp_bwd_tiles``."""
    ct_dt, ct_y, ct_k1, ct_leaves = _altmlp_reverse(dt, y, k1, leaves, cts, rtol, atol, False)
    return torch.zeros_like(ct_dt), ct_dt, ct_y, ct_k1, tuple(ct_leaves)


def plain_altmlp_bwd_tiles(t, dt, y, k1, leaves, cts, rtol, atol, rows=None):
    """``_altmlp_bwd_math`` in the order of sums of K8 (the reverse tile
    body): per tile of ``rows`` rows (the kernel's ``ALT_BWD_ROWS`` by
    default) the chain on the tile's rows (``_altmlp_reverse`` with
    ``tiled``: each cotangent element over the rows in order, stage after
    stage, the input cotangents' sums split over lanes, ct_dt summed in
    float64 and rounded once), then the tiles' sums in tile order (the slot
    sum). ct_y and ct_k1 are per row. For the tests: the CPU path of
    ``altmlp_normed_sweep_bwd`` is ``_altmlp_bwd_math``."""
    rows = ALT_BWD_ROWS if rows is None else rows
    leaves = tuple(leaves)
    cyn, ck7, *scalars = cts
    ct_dt, ct_leaves, ct_y, ct_k1 = None, None, [], []
    for r0 in range(0, y.shape[0], rows):
        tile = slice(r0, r0 + rows)
        d, cy, ck, cl = _altmlp_reverse(dt, y[tile], k1[tile], leaves,
                                        (cyn[tile], ck7[tile], *scalars), rtol, atol, True)
        d = d.to(y.dtype)
        ct_dt = d if ct_dt is None else ct_dt + d
        ct_leaves = cl if ct_leaves is None else [a + b for a, b in zip(ct_leaves, cl)]
        ct_y.append(cy)
        ct_k1.append(ck)
    return (torch.zeros_like(ct_dt), ct_dt, torch.cat(ct_y), torch.cat(ct_k1),
            tuple(ct_leaves))


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, kernel for CUDA tensors.
# ---------------------------------------------------------------------------


def _check_cuda_args(y, k1, leaves, extra=()):
    if y.dim() != 2:
        raise ValueError(f"y must be (batch, dim), got {tuple(y.shape)}")
    B, D = y.shape
    depth = _depth(leaves)
    H = leaves[0].shape[0]
    want = {"k1": (k1, (B, D))}
    for i in range(depth):
        up_w, up_b, dn_w, dn_b = leaves[4 * i:4 * i + 4]
        want.update({f"up_{i}.weight": (up_w, (H, D)), f"up_{i}.bias": (up_b, (H,)),
                     f"down_{i}.weight": (dn_w, (D, H)), f"down_{i}.bias": (dn_b, (D,))})
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
    return B, D, H, depth


def _leaf_pointers(leaves):
    """A host array of the leaves' device pointers (the kernels copy it
    into their launch parameters during the call)."""
    return (ctypes.c_void_p * len(leaves))(*[x.data_ptr() for x in leaves])


def _library(depth):
    """The kernels' library, for AlternatingMLP of ``depth`` (the kernels
    take its leaves' pointers in a fixed-size launch parameter)."""
    from regneuralde_tpu_torch.ops import _cuda

    lib = _cuda.library()
    if depth > lib.regnde_altmlp_max_depth():
        raise ValueError(f"depth {depth} > {lib.regnde_altmlp_max_depth()}")
    return lib


def _pad4(n):
    return (n + 3) // 4 * 4


class AltFwdPlan(NamedTuple):
    """The forward tile body at a batch and widths: ``rows`` a tile,
    ``slot_rows`` a norm-sum slot, ``tiles`` (K7's blocks, K3's grid where
    the card holds them), ``slots`` (the slots holding a row of the batch)
    and ``smem_bytes`` a block."""
    rows: int
    slot_rows: int
    tiles: int
    slots: int
    smem_bytes: int


def altmlp_fwd_plan(B, D, H, depth) -> AltFwdPlan:
    """``csrc/altmlp_tsit5.cuh``'s sizes of the forward body
    (``alt_forward_floats``, ``altmlp_fwd_smem_bytes``) at ``B x D x H x
    depth``; raises ``ValueError`` for widths whose weights and tile need
    more shared memory than ``SMEM_LIMIT``."""
    R, S = ALT_FWD_ROWS, ALT_SLOT_ROWS
    n, pw = R * D, R * max(_pad4(D), _pad4(H))
    parts = [n, 7 * n, n, n, 2 * pw, 2 * pw, 3 * (R // S) * (_THREADS // 32)]
    leaves = depth * (2 * _pad4(H * D) + _pad4(H) + _pad4(D))  # each leaf from 16 bytes
    smem = 4 * (leaves + 4 + sum(_pad4(x) for x in parts))
    if smem > SMEM_LIMIT:
        raise ValueError(f"K7's forward tile body holds at most {SMEM_LIMIT} bytes of shared "
                         f"memory; dim {D}, hidden {H}, depth {depth} need {smem}")
    return AltFwdPlan(R, S, -(-B // R), -(-B // S), smem)


@functools.lru_cache(maxsize=16)
def check_fwd_plan(lib, D, H, depth) -> AltFwdPlan:
    """``altmlp_fwd_plan`` held to the library's constants (once a shape)."""
    plan = altmlp_fwd_plan(0, D, H, depth)
    if (lib.regnde_altmlp_rows() != ALT_FWD_ROWS
            or lib.regnde_altmlp_slot_rows() != ALT_SLOT_ROWS
            or lib.regnde_altmlp_fwd_smem_bytes(depth, D, H) != plan.smem_bytes):
        raise RuntimeError("altmlp_fwd_plan disagrees with csrc/altmlp_tsit5.cuh's sizes")
    return plan


def _cuda_altmlp_fwd(t, dt, y, k1, leaves, rtol, atol):
    from regneuralde_tpu_torch.ops import _cuda

    B, D, H, depth = _check_cuda_args(y, k1, leaves)
    plan = altmlp_fwd_plan(B, D, H, depth)
    lib = _library(depth)
    check_fwd_plan(lib, D, H, depth)
    t32, dt32 = _scalar_f32(t, y), _scalar_f32(dt, y)
    y_new = torch.empty_like(y)
    k7 = torch.empty_like(y)
    partials = torch.empty((plan.tiles * (plan.rows // plan.slot_rows), 3), device=y.device)
    sums = torch.empty(3, device=y.device)
    ptrs = _leaf_pointers(leaves)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    code = lib.regnde_altmlp_fwd(
        _ptr(t32), _ptr(dt32), _ptr(y), _ptr(k1), ctypes.cast(ptrs, ctypes.c_void_p),
        depth, _ptr(y_new), _ptr(k7), _ptr(partials), _ptr(sums), B, D, H,
        float(rtol), float(atol), ctypes.c_void_p(stream))
    _cuda.check(code, "AlternatingMLP Tsit5 forward kernel")
    LAUNCHES["altmlp_tsit5_fwd"] += 1
    return NormedSweep(y_new, k7, sums[0], sums[1], sums[2])


class AltBwdPlan(NamedTuple):
    """The reverse tile body at a batch and widths: ``rows`` a tile,
    ``tiles`` (K8's blocks), ``smem_bytes`` a block, ``record_floats`` of
    activation records a block in device memory (stages 1 to 4), and
    whether some weight or bias cotangent is held in shared memory rather
    than in registers (``cw_in_smem``: past ``ALT_REG_LAYERS`` layers, or a
    layer of more 2 x 2 tiles or outputs than a block has threads)."""
    rows: int
    tiles: int
    smem_bytes: int
    record_floats: int
    cw_in_smem: bool


def altmlp_bwd_plan(B, D, H, depth) -> AltBwdPlan:
    """``csrc/altmlp_tsit5.cuh``'s sizes of the reverse body
    (``alt_reverse_floats``, ``altmlp_bwd_smem_bytes``,
    ``alt_reverse_records``) at ``B x D x H x depth``; raises ``ValueError``
    for widths whose weights and tile need more shared memory than
    ``SMEM_LIMIT``."""
    R = ALT_BWD_ROWS
    n, pw = R * D, R * max(_pad4(D), _pad4(H))
    rec = R * depth * (_pad4(D) + _pad4(H))
    in_smem = (2 * depth > ALT_REG_LAYERS or ((D + 1) // 2) * ((H + 1) // 2) > _THREADS
               or max(D, H) > _THREADS)
    leaf = depth * (2 * H * D + H + D)
    parts = [n, 7 * n, 7 * n, n, n, n, n, rec, rec, rec, rec, 2 * pw, 2 * pw,
             2 * (_THREADS // 32)]
    padded = depth * (H * (D + 1) + H + D * (H + 1) + D)
    smem = 4 * (padded + 4 + sum(_pad4(x) for x in parts) + (_pad4(leaf) if in_smem else 0))
    if smem > SMEM_LIMIT:
        raise ValueError(f"K8's reverse tile body holds at most {SMEM_LIMIT} bytes of shared "
                         f"memory; dim {D}, hidden {H}, depth {depth} need {smem}")
    return AltBwdPlan(R, -(-B // R), smem, 4 * rec, in_smem)


@functools.lru_cache(maxsize=16)
def check_bwd_plan(lib, D, H, depth) -> AltBwdPlan:
    """``altmlp_bwd_plan`` held to the library's constants (once a shape)."""
    plan = altmlp_bwd_plan(0, D, H, depth)
    if (lib.regnde_altmlp_bwd_rows() != ALT_BWD_ROWS
            or lib.regnde_altmlp_bwd_smem_bytes(depth, D, H) != plan.smem_bytes):
        raise RuntimeError("altmlp_bwd_plan disagrees with csrc/altmlp_tsit5.cuh's sizes")
    return plan


@functools.lru_cache(maxsize=8)
def _altmlp_bwd_scratch(lib, B, D, H, depth, dev, stream):
    """K8's scratch at ``B x D x H x depth`` on ``stream``: the per-tile
    slots (the leaves' cotangents, then ct_t and ct_dt), the blocks'
    activation records, and the norm sums' three cotangents. Nothing of it
    outlives a launch, and launches on one stream run in order, so it is
    made once and reused."""
    plan = check_bwd_plan(lib, D, H, depth)
    tiles = -(-B // plan.rows)
    n_leaf = depth * (2 * H * D + H + D)
    return (torch.empty((tiles, n_leaf + 2), device=dev),
            torch.empty((tiles, plan.record_floats), device=dev), torch.empty(3, device=dev))


@functools.lru_cache(maxsize=8)
def _altmlp_walk_scratch(lib, B, D, H, depth, dev, stream):
    """K4's scratch for AlternatingMLP at ``B x D x H x depth`` on
    ``stream`` (``AltDyn`` in ``csrc/whole_solve.cu``): a weight-cotangent
    slot a block, then from float ``pad4(tiles * leaf floats)`` on each
    block's activation records; made once, as ``_altmlp_bwd_scratch``."""
    plan = check_bwd_plan(lib, D, H, depth)
    tiles = -(-B // plan.rows)
    n_leaf = depth * (2 * H * D + H + D)
    return torch.empty(_pad4(tiles * n_leaf) + tiles * plan.record_floats, device=dev)


def _cuda_altmlp_bwd(t, dt, y, k1, leaves, cts, rtol, atol):
    from regneuralde_tpu_torch.ops import _cuda

    cyn, ck7 = cts[0], cts[1]
    B, D, H, depth = _check_cuda_args(
        y, k1, leaves, {"ct_y_new": (cyn, tuple(y.shape)),
                        "ct_k7": (ck7, tuple(y.shape))})
    altmlp_bwd_plan(B, D, H, depth)
    lib = _library(depth)
    dt32 = _scalar_f32(dt, y)
    dev = y.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    slots, recs, ct_scalars = _altmlp_bwd_scratch(lib, B, D, H, depth, dev, stream)
    torch.stack([_scalar_f32(c, y) for c in cts[2:]], out=ct_scalars)
    ct_y = torch.empty_like(y)
    ct_k1 = torch.empty_like(y)
    n_leaf = sum(x.numel() for x in leaves)
    out = torch.empty(n_leaf + 2, device=dev)
    ptrs = _leaf_pointers(leaves)
    code = lib.regnde_altmlp_bwd(
        _ptr(dt32), _ptr(y), _ptr(k1), ctypes.cast(ptrs, ctypes.c_void_p), depth,
        _ptr(cyn), _ptr(ck7), _ptr(ct_scalars), _ptr(ct_y), _ptr(ct_k1),
        _ptr(slots), _ptr(recs), _ptr(out), B, D, H, float(rtol), float(atol),
        ctypes.c_void_p(stream))
    _cuda.check(code, "AlternatingMLP Tsit5 backward kernel")
    LAUNCHES["altmlp_tsit5_bwd"] += 1
    ct_leaves, off = [], 0
    for x in leaves:
        ct_leaves.append(out[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return out[n_leaf], out[n_leaf + 1], ct_y, ct_k1, tuple(ct_leaves)


def altmlp_normed_sweep(t, dt, y, k1, leaves: Sequence[torch.Tensor], rtol, atol
                        ) -> NormedSweep:
    """K7 or its plain version: ``(y_new, k7, err_ssq, num_ssq, den_ssq)``."""
    if y.device.type == "cuda":
        return _cuda_altmlp_fwd(t, dt, y, k1, tuple(leaves), rtol, atol)
    if y.device.type == "cpu":
        return plain_altmlp_normed_sweep(t, dt, y, k1, leaves, rtol, atol)
    raise RuntimeError(f"no AlternatingMLP Tsit5 forward for device {y.device}")


def altmlp_normed_sweep_bwd(t, dt, y, k1, leaves: Sequence[torch.Tensor], cts,
                            rtol, atol) -> Tuple:
    """K8 or its plain version: ``(ct_t, ct_dt, ct_y, ct_k1, ct_leaves)``."""
    if y.device.type == "cuda":
        return _cuda_altmlp_bwd(t, dt, y, k1, tuple(leaves), tuple(cts), rtol, atol)
    if y.device.type == "cpu":
        return _altmlp_bwd_math(t, dt, y, k1, tuple(leaves), tuple(cts), float(rtol),
                                float(atol))
    raise RuntimeError(f"no AlternatingMLP Tsit5 backward for device {y.device}")


class AltMLPNormedSweepFn(torch.autograd.Function):
    """The normed trial step with the hand backward as its gradient."""

    @staticmethod
    def forward(ctx, t, dt, y, k1, rtol, atol, *leaves):
        ctx.save_for_backward(t, dt, y, k1, *leaves)
        ctx.tols = (rtol, atol)
        return tuple(altmlp_normed_sweep(t, dt, y, k1, leaves, rtol, atol))

    @staticmethod
    def backward(ctx, cyn, ck7, ce, cn, cd):
        t, dt, y, k1, *leaves = ctx.saved_tensors
        scalar0 = y.new_zeros(())
        cts = (torch.zeros_like(y) if cyn is None else cyn.contiguous(),
               torch.zeros_like(y) if ck7 is None else ck7.contiguous(),
               *(scalar0 if c is None else c for c in (ce, cn, cd)))
        ct_t, ct_dt, ct_y, ct_k1, ct_leaves = altmlp_normed_sweep_bwd(
            t, dt, y, k1, leaves, cts, *ctx.tols)
        return (ct_t.to(t.dtype).reshape(t.shape), ct_dt.to(dt.dtype).reshape(dt.shape),
                ct_y, ct_k1, None, None, *ct_leaves)


def make_alternating_mlp_sweep(rtol: float, atol: float):
    """The fused trial-step pair ``(sweep, sweep_bwd)`` for
    ``NeuralODE(AlternatingMLP(...), fused="step")`` over its leaves: the
    forward differentiable through ``AltMLPNormedSweepFn``, the backward one
    K8 launch (or its plain version) for the fast adjoint, with no forward
    replay."""
    rtol, atol = float(rtol), float(atol)

    def sweep(t, dt, y, k1, leaves):
        t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
        dt = torch.as_tensor(dt, dtype=y.dtype, device=y.device)
        return NormedSweep(*AltMLPNormedSweepFn.apply(t, dt, y, k1, rtol, atol,
                                                      *leaves))

    def sweep_bwd(t, dt, y, k1, leaves, cts):
        return altmlp_normed_sweep_bwd(t, dt, y, k1, tuple(leaves), tuple(cts),
                                       rtol, atol)

    return sweep, sweep_bwd


def make_plain_alternating_mlp_sweep(rtol: float, atol: float):
    """The plain versions of K7/K8 on any device, as ``(sweep,
    sweep_bwd)``: the unfused path of ``NeuralODE(fused=False)``, the same
    trial-step algebra with no kernel."""
    rtol, atol = float(rtol), float(atol)

    def sweep(t, dt, y, k1, leaves):
        return plain_altmlp_normed_sweep(t, dt, y, k1, leaves, rtol, atol)

    def sweep_bwd(t, dt, y, k1, leaves, cts):
        return _altmlp_bwd_math(t, dt, y, k1, tuple(leaves), tuple(cts), rtol, atol)

    return sweep, sweep_bwd
