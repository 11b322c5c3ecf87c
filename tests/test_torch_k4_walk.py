"""K4's reverse walk for MLPDynamics (``csrc/mlp_walk.cuh``) on the CPU:
one trial step in the kernel's own schedule (``whole_solve.plain_walk_step``:
the seed phase, then per stage phase A, ``cp2_i W2`` summed over column
blocks in block order, and phase B with the kernel's epilogue) against the
plain normed backward ``fused_mlp._normed_bwd_math`` and against the JAX
package's ``pallas_mlp._normed_bwd_math``; and the tile plan the wrapper
hands the kernel (``whole_solve.walk_plan``).

Both packages get the same numpy arrays from a seeded generator, at
``MLPDynamics(16, 12)`` with batch 8 and ``MLPDynamics(40, 24)`` with batch
13 (a ragged tile). The kernel itself runs only on the card:
``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phases 5 and 12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import weight_cotangents as wc
from regneuralde_tpu_torch.ops import whole_solve as ws

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
T, DT = 0.07, 0.11
SHAPES = [(8, 16, 12), (13, 40, 24)]
# the norm sums' cotangents (err, num, den): the training step's, or none
NORM_CTS = {"norms": (0.7, 1.3, -0.4), "rows_only": (0.0, 0.0, 0.0)}


def _case(B, D, H, seed=0):
    """Leaves at three times LeCun's scale (the error estimate well above
    its float32 floor), y, k1, the row cotangents and the pass-through
    rows of a rejected step."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        W1=f32(rng.normal(size=(H, D + 1)) * 3 / np.sqrt(D + 1)),
        b1=f32(rng.normal(size=H) * 0.1),
        W2=f32(rng.normal(size=(D, H + 1)) * 3 / np.sqrt(H + 1)),
        b2=f32(rng.normal(size=D) * 0.1),
        y=f32(rng.normal(size=(B, D)) * 0.5),
        k1=f32(rng.normal(size=(B, D)) * 0.3),
        ct_y_new=f32(rng.normal(size=(B, D))),
        ct_k7=f32(rng.normal(size=(B, D))),
        pass_y=f32(rng.normal(size=(B, D))),
        pass_k1=f32(rng.normal(size=(B, D))),
    )


def _plan(B, D, H, col_blocks=3):
    """A plan with several column blocks, so phase A's partials are summed
    over blocks as on the card at the flagship (8 blocks of 98 columns)."""
    C = -(-D // col_blocks)
    return ws.WalkPlan(16, C, -(-B // 16), -(-D // C), 1, 0)


def _run(c, dtype, norms, rejected):
    """The plain backward and the walk's schedule on the same inputs and
    stage residuals: each ``(ct_t, ct_dt, ct_y, ct_k1, cW1, cb1, cW2,
    cb2)``, the walk's weights from its rows by the plain contraction."""
    tt = lambda a: torch.tensor(a, dtype=dtype)
    leaves = [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]
    parts = fm._split_params(*leaves)
    y, k1, t, dt = tt(c["y"]), tt(c["k1"]), tt(T), tt(DT)
    _, (ks, hs) = fm._reference_normed_sweep_res(t, dt, y, k1, parts, RTOL, ATOL)
    scal = tuple(tt(v) for v in NORM_CTS[norms])
    rows = (None, None) if rejected else (tt(c["ct_y_new"]), tt(c["ct_k7"]))
    passes = (tt(c["pass_y"]), tt(c["pass_k1"])) if rejected else (None, None)
    zero = torch.zeros_like(y)
    plain = fm._normed_bwd_math(t, dt, y, k1, parts,
                                tuple(zero if r is None else r for r in rows) + scal,
                                RTOL, ATOL, res=(ks, hs))
    plain = list(plain[:4]) + list(plain[4])
    if rejected:
        plain[2], plain[3] = passes[0] + plain[2], passes[1] + plain[3]
    B, D = y.shape
    walk = ws.plain_walk_step(t, dt, y, k1, leaves, rows + scal, RTOL, ATOL,
                              (ks[1:], hs), _plan(B, D, leaves[0].shape[0]), *passes)
    walk = list(walk[:4]) + list(wc.weight_cotangents_plain(*walk[4]))
    return plain, walk


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


NAMES = ["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"]
CASES = [(shape, norms, rejected) for shape in SHAPES for norms in NORM_CTS
         for rejected in (False, True)]


@pytest.mark.parametrize("shape, norms, rejected", CASES)
def test_walk_schedule_is_the_plain_backward_in_float64(shape, norms, rejected):
    """The same function summed in another order: every output within
    1e-12 (relative Frobenius) in float64."""
    plain, walk = _run(_case(*shape), torch.float64, norms, rejected)
    for name, a, b in zip(NAMES, walk, plain):
        assert _rel(a, b) <= 1e-12, name


@pytest.mark.parametrize("shape, norms, rejected", CASES)
def test_walk_schedule_float32_within_plain_distance_from_float64(shape, norms, rejected):
    """In float32 the norm seeds (1/atol) amplify the rows' rounding, and
    ct_t and ct_dt are sums that cancel: each output of the schedule lies
    from the float64 result within 3 times the float32 plain backward's
    distance, plus 1e-6 (the bound the card's tests hold K4 to)."""
    c = _case(*shape)
    exact, _ = _run(c, torch.float64, norms, rejected)
    plain, walk = _run(c, torch.float32, norms, rejected)
    for name, a, b, x in zip(NAMES, walk, plain, exact):
        assert _rel(a, x) <= 3 * _rel(b, x) + 1e-6, (name, _rel(a, x), _rel(b, x))


@pytest.mark.parametrize("shape, norms, rejected", CASES)
def test_walk_schedule_matches_jax_normed_bwd_math(shape, norms, rejected):
    """Against the JAX package's hand backward within the tolerance
    ``test_torch_fused_mlp`` holds the plain normed backward to (the JAX
    package's own, tests/test_pallas_fused.py:180-188). A rejected step
    seeds no row cotangent and passes the carry's rows through."""
    c = _case(*shape)
    params = {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}
    rows = ((jnp.zeros_like(c["y"]),) * 2 if rejected
            else (jnp.asarray(c["ct_y_new"]), jnp.asarray(c["ct_k7"])))
    ct_t, ct_dt, ct_y, ct_k1, (cw1x, cw1t, cb1, cw2h, cw2t, cb2) = jmlp._normed_bwd_math(
        jnp.float32(T), jnp.float32(DT), jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
        jmlp._split_params(params), rows + tuple(jnp.float32(v) for v in NORM_CTS[norms]),
        RTOL, ATOL)
    ct_y, ct_k1 = np.asarray(ct_y), np.asarray(ct_k1)
    if rejected:
        ct_y, ct_k1 = c["pass_y"] + ct_y, c["pass_k1"] + ct_k1
    want = [np.asarray(ct_t), np.asarray(ct_dt), ct_y, ct_k1,
            np.concatenate([np.asarray(cw1x), np.asarray(cw1t)], 0).T,
            np.asarray(cb1).reshape(-1),
            np.concatenate([np.asarray(cw2h), np.asarray(cw2t)], 0).T,
            np.asarray(cb2).reshape(-1)]
    _, walk = _run(c, torch.float32, norms, rejected)
    for name, a, b in zip(NAMES, walk, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-2, atol=5e-4, err_msg=name)


# the flagship, the card tests' and chip_smoke.py's MLPDynamics shapes, and
# edge batches
PLAN_SHAPES = [(512, 784, 100), (1, 40, 24), (13, 40, 24), (64, 40, 24), (1040, 64, 32),
               (8, 16, 12), (5, 8, 5), (2048, 784, 100)]


def _tiles(plan, B, D):
    """Each block's tile in each row chunk, as the kernel's ``walk_tile``
    cuts them: ``(row0, rows, d0, cols, col_block)``; ``rows`` may be 0 in
    the last chunk."""
    for chunk in range(plan.chunks):
        for blk in range(plan.tiles):
            rb, db = divmod(blk, plan.col_blocks)
            row0 = (chunk * plan.row_blocks + rb) * plan.rows
            d0 = db * plan.cols
            yield (row0, max(0, min(plan.rows, B - row0)), d0,
                   max(0, min(plan.cols, D - d0)), db)


def _covers_once(plan, B, D, H):
    """Every (row, d) of the batch in exactly one tile; every (row, h) of
    ct_pre1 (h up to H, W2's time column) reduced by exactly one block, the
    one of its row block whose column block is the row's index modulo the
    column blocks (``walk_reduce``); no tile past the batch's columns."""
    elems = np.zeros((B, D), np.int64)
    hidden = np.zeros((B, H + 1), np.int64)
    for row0, rows, d0, cols, db in _tiles(plan, B, D):
        assert cols >= 1 and 0 <= rows <= plan.rows and cols <= plan.cols
        elems[row0:row0 + rows, d0:d0 + cols] += 1
        for r in range(db, plan.rows, plan.col_blocks):
            if r < rows:
                hidden[row0 + r] += 1
    return (elems == 1).all() and (hidden == 1).all()


@pytest.mark.parametrize("sms", [132, 33])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_walk_plan_covers_every_element_once_within_shared_memory(shape, sms):
    B, D, H = shape
    plan = ws.walk_plan(B, D, H, sms)
    assert _covers_once(plan, B, D, H)
    assert plan.rows in ws.WALK_ROWS and plan.cols % ws.WALK_COL_ALIGN == 0
    assert plan.rows * plan.cols <= ws.WALK_MAX_TILE and plan.tiles <= sms
    assert plan.smem_bytes == ws.walk_smem_bytes(plan.rows, plan.cols, H)
    assert plan.smem_bytes <= ws.SMEM_LIMIT == 232_448


@pytest.mark.parametrize("sms", [8, 33])
def test_walk_plan_walks_in_row_chunks_on_a_small_card(sms):
    """With fewer multiprocessors than tiles the batch is walked in row
    chunks, each tile still once."""
    plan = ws.walk_plan(512, 784, 100, sms)
    assert plan.tiles <= sms and plan.chunks > 1
    assert _covers_once(plan, 512, 784, 100)


def test_walk_plan_at_the_flagship():
    """128 tiles of 32 rows x 100 columns (the last column block 84 wide),
    one a multiprocessor of 132, in 206,464 bytes: W1 and W2 read by 16 row
    blocks a stage."""
    assert ws.walk_plan(512, 784, 100, 132) == ws.WalkPlan(32, 100, 16, 8, 1, 206_464)
    assert ws.solve_smem_bytes(32, 100, 100) < 206_464  # the replay runs K3's stages in it


def test_walk_plan_refuses_what_no_tile_fits():
    with pytest.raises(ValueError, match="no tile plan"):
        ws.walk_plan(512, 784, 100, 132, limit=20_000)
