"""The weight-cotangent contraction of the MLPDynamics backward kernels.

K2, K14, K12 and K4<MlpDyn> (``ops.fused_mlp``, ``ops.fused_mlp_lanes``,
``ops.whole_solve``) store, for each stage of each row they reverse, the
rows ``cp2`` (K, D) = the second layer's pre-activation cotangent, ``he``
(K, H+2) = ``[h, t_i, 1]``, ``cp1`` (K, H) = the first layer's and ``ye``
(K, D+2) = ``[y_i, t_i, 1]``. The weight cotangents in ``nn.Linear``
layout are two products over those K rows::

    cW2 | cb2 = cp2^T he        cW1 | cb1 = cp1^T ye

JAX sums them inside its Pallas kernels, carried from one grid step to the
next (``regneuralde_tpu/ops/pallas_mlp.py:1263``, ``:405``, ``:814``;
``regneuralde_tpu/ops/pallas_solve.py:629``). On the card one kernel
(``csrc/weight_cotangents.cu``) cuts K into chunks by :func:`plan`, sums
each chunk of each 64 x 128 output tile in a block, and a second kernel
sums the chunks in chunk order: no atomics, so two runs are bitwise equal.
The four backward kernels launch it at their end; :func:`weight_cotangents`
runs it alone on given rows. :func:`weight_cotangents_plain` is its plain
version, ``torch.mm`` split into main and last column; no path on the card
calls it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

# Launches of the contraction, counted by every wrapper that launches it:
# this module's and the four backward wrappers.
LAUNCHES = {"weight_cotangents": 0}

# The chunk kernel's output tile (kBM x kBN in csrc/weight_cotangents.cu):
# each product's wider side on TILE_ROWS, its narrower on TILE_COLS.
TILE_ROWS, TILE_COLS = 64, 128
CHUNK_ALIGN = 8  # rows of a pipeline stage (kBK)
# About four blocks on each of an H100's 132 SMs, what the chunk kernel's
# registers (128 threads x 128) and shared memory (24 KB) let reside at once.
TARGET_BLOCKS = 528
# Chunks of at least 64 rows: fewer, longer ones sum in float32 further
# from the float64 product than torch.mm does (at K = 384 in one chunk, 3.30
# times its distance on the H100; in six, 1.00: tools/torch_wcot_variants.py).
MIN_CHUNK_ROWS = 64
MAX_PARTIAL_FLOATS = 1 << 24  # 64 MB of partial sums at most


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch() -> None:
    """One launch of the contraction, by a wrapper whose kernel call has
    just returned without error."""
    LAUNCHES["weight_cotangents"] += 1


class Plan(NamedTuple):
    chunk_rows: int  # rows of K a chunk sums, a multiple of CHUNK_ALIGN
    nchunks: int  # ceil(K / chunk_rows), 1 when K = 0
    partial_floats: int  # the partial sums' scratch, in floats


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round4(x: int) -> int:
    return _cdiv(x, 4) * 4


def plan(K: int, D: int, H: int) -> Plan:
    """How the contraction cuts K rows at state width D and hidden width H:
    as many chunks as keep about ``TARGET_BLOCKS`` blocks in flight, no
    chunk under ``MIN_CHUNK_ROWS`` rows and no more than
    ``MAX_PARTIAL_FLOATS`` of partial sums, at least one chunk. Chunks are
    consecutive: chunk ``c`` holds rows ``[c * chunk_rows, min(K, (c + 1) *
    chunk_rows))``. Each chunk's partials take ``r4(rows) * r4(cols)``
    floats a product, ``r4`` rounding up to a multiple of 4."""
    if K < 0 or D < 1 or H < 1:
        raise ValueError(f"plan needs K >= 0, D >= 1 and H >= 1, got {K}, {D}, {H}")
    shapes = ((D, H + 2), (H, D + 2))
    tiles = sum(_cdiv(max(m, n), TILE_ROWS) * _cdiv(min(m, n), TILE_COLS) for m, n in shapes)
    per_chunk = sum(_round4(m) * _round4(n) for m, n in shapes)
    n = max(1, min(TARGET_BLOCKS // tiles, K // MIN_CHUNK_ROWS,
                   MAX_PARTIAL_FLOATS // per_chunk))
    rows = max(CHUNK_ALIGN, _cdiv(_cdiv(K, n), CHUNK_ALIGN) * CHUNK_ALIGN)
    nchunks = max(1, _cdiv(K, rows))
    return Plan(rows, nchunks, nchunks * per_chunk)


def weight_cotangents_plain(cp2, he, cp1, ye):
    """``(cW1, cb1, cW2, cb2)`` as ``torch.mm`` of the rows, split into the
    main columns and the last (the bias)."""
    c2 = torch.mm(cp2.t(), he)
    c1 = torch.mm(cp1.t(), ye)
    return (c1[:, :-1].contiguous(), c1[:, -1].contiguous(),
            c2[:, :-1].contiguous(), c2[:, -1].contiguous())


def _check_rows(cp2, he, cp1, ye):
    if cp2.dim() != 2 or cp1.dim() != 2:
        raise ValueError("cp2 and cp1 must be (rows, width)")
    K, D = cp2.shape
    H = cp1.shape[1]
    for name, x, shape in (("cp2", cp2, (K, D)), ("he", he, (K, H + 2)),
                           ("cp1", cp1, (K, H)), ("ye", ye, (K, D + 2))):
        if x.device != cp2.device:
            raise ValueError(f"{name} is on {x.device}, cp2 on {cp2.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return K, D, H


def cuda_scratch(K: int, D: int, H: int, device):
    """The partial sums' scratch on ``device``, the chunk rows and the
    scratch's floats: the contraction's arguments after the rows."""
    p = plan(K, D, H)
    return torch.empty(p.partial_floats, device=device), p.chunk_rows, p.partial_floats


def _cuda_weight_cotangents(cp2, he, cp1, ye):
    from regneuralde_tpu_torch.ops import _cuda

    K, D, H = _check_rows(cp2, he, cp1, ye)
    dev = cp2.device
    cW1, cb1 = torch.empty((H, D + 1), device=dev), torch.empty(H, device=dev)
    cW2, cb2 = torch.empty((D, H + 1), device=dev), torch.empty(D, device=dev)
    partials, rows, floats = cuda_scratch(K, D, H, dev)
    lib = _cuda.library()
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    code = lib.regnde_weight_cotangents(
        *map(ptr, (cp2, he, cp1, ye, cW1, cb1, cW2, cb2, partials)), K, D, H, rows, floats,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _cuda.check(code, "weight-cotangent contraction")
    count_launch()
    return cW1, cb1, cW2, cb2


def weight_cotangents(cp2, he, cp1, ye):
    """The contraction's kernel on CUDA tensors, its plain version on CPU
    tensors: ``(cW1, cb1, cW2, cb2)`` from the rows ``cp2`` (K, D), ``he``
    (K, H+2), ``cp1`` (K, H), ``ye`` (K, D+2)."""
    if cp2.device.type == "cuda":
        return _cuda_weight_cotangents(cp2, he, cp1, ye)
    if cp2.device.type == "cpu":
        _check_rows(cp2, he, cp1, ye)
        return weight_cotangents_plain(cp2, he, cp1, ye)
    raise RuntimeError(f"no weight-cotangent contraction for device {cp2.device}")
