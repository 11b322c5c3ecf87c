"""K3 for MLPDynamics (``csrc/mlp_solve.cuh``) on the CPU: one trial step in
the kernel's own schedule (``whole_solve.plain_solve_step``: per stage the
stage input, phase A's partials of ``y_i W1x^T`` per column block summed in
block order, tanh, phase B, then the norm sums) against the port's plain
residual sweep ``fused_mlp._reference_normed_sweep_res`` and against the
JAX package's ``pallas_mlp.make_normed_algebra_fwd_res``; and the tile plan
K3 shares with K4's walk (``whole_solve.walk_plan``).

Both packages get the same numpy arrays from a seeded generator, at
``MLPDynamics(40, 24)`` with batch 8 and 13 (a ragged tile), on plans of 1,
2 and 5 column blocks, for a step the controller accepts and one it
rejects. The kernel itself runs only on the card:
``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phases 5, 7 and 12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import whole_solve as ws

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
D, H = 40, 24
BATCHES = (8, 13)
COL_BLOCKS = (1, 2, 5)
# (t, dt) of a step the controller accepts (eest 0.5) and of one it rejects
# (eest 3.5-3.8)
STEPS = {"accepted": (0.15, 0.07), "rejected": (0.1, 0.2)}
OUT_NAMES = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]


def _case(B, seed=0):
    """Leaves at LeCun's scale (as ``test_torch_whole_solve_residuals``), y
    and k1."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        W1=f32(rng.normal(size=(H, D + 1)) / np.sqrt(D + 1)),
        b1=f32(rng.normal(size=H) * 0.1),
        W2=f32(rng.normal(size=(D, H + 1)) / np.sqrt(H + 1)),
        b2=f32(rng.normal(size=D) * 0.1),
        y=f32(rng.normal(size=(B, D)) * 0.5),
        k1=f32(rng.normal(size=(B, D)) * 0.3),
    )


def _plan(B, col_blocks):
    """A plan of ``col_blocks`` column blocks over D (16-row tiles)."""
    C = -(-D // col_blocks)
    return ws.WalkPlan(16, C, -(-B // 16), -(-D // C), 1, 0)


def _run(c, dtype, step, col_blocks):
    """The plain residual sweep and K3's schedule on the same inputs, each
    as the list of its outputs: the quintuple, k2..k7 and the six hidden
    layers."""
    tt = lambda a: torch.tensor(a, dtype=dtype)
    leaves = [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]
    y, k1 = tt(c["y"]), tt(c["k1"])
    t, dt = (tt(v) for v in STEPS[step])
    flat = lambda r: [*r[0], *r[1][0][1:], *r[1][1]]
    plain = fm._reference_normed_sweep_res(t, dt, y, k1, fm._split_params(*leaves), RTOL,
                                           ATOL)
    solve = ws.plain_solve_step(t, dt, y, k1, leaves, RTOL, ATOL,
                                _plan(y.shape[0], col_blocks))
    return flat(plain), flat(solve)


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


NAMES = OUT_NAMES + [f"k{j}" for j in range(2, 8)] + [f"h{j}" for j in range(1, 7)]
CASES = [(B, step, n) for B in BATCHES for step in STEPS for n in COL_BLOCKS]


@pytest.mark.parametrize("B, step, col_blocks", CASES)
def test_solve_schedule_is_the_plain_sweep_in_float64(B, step, col_blocks):
    """The same function summed in another order: every output within
    1e-12 (relative Frobenius) in float64; the rejected step's error
    estimate above 1."""
    plain, solve = _run(_case(B), torch.float64, step, col_blocks)
    eest = (plain[2] / (B * D)).sqrt().item()
    assert (eest > 1.0) == (step == "rejected"), eest
    for name, a, b in zip(NAMES, solve, plain):
        assert _rel(a, b) <= 1e-12, name


@pytest.mark.parametrize("B, step, col_blocks", CASES)
def test_solve_schedule_float32_within_plain_distance_from_float64(B, step, col_blocks):
    """In float32 each output of the schedule lies from the float64 result
    within 3 times the float32 plain sweep's distance, the worst over eight
    seeds of each (as ``chip_smoke.py`` phase 5 takes the worst over a
    solve's trial steps): err_ssq, num_ssq and den_ssq sum squares of
    differences that cancel (the embedded error, k7 - k6, y_new - g6), so on
    one input either order's distance is luck, spread over 0.02-18 times
    the other's."""
    worst = np.zeros((2, len(NAMES)))
    for seed in range(8):
        c = _case(B, seed)
        exact, _ = _run(c, torch.float64, step, col_blocks)
        plain, solve = _run(c, torch.float32, step, col_blocks)
        for j, (a, b, x) in enumerate(zip(solve, plain, exact)):
            worst[:, j] = np.maximum(worst[:, j], (_rel(a, x), _rel(b, x)))
    for name, (a, b) in zip(NAMES, worst.T):
        assert a <= 3 * b, (name, a, b)


@pytest.mark.parametrize("B, step, col_blocks", CASES)
def test_solve_schedule_matches_jax_fwd_res(B, step, col_blocks):
    """Against the JAX package's residual-capturing forward on the same
    float32 inputs, at the tolerances ``test_torch_whole_solve_residuals``
    holds the plain sweep to (rows and stages rtol 2e-5, the three sums
    rtol 1e-4, atol 5e-7: ATen's and XLA's exp differ by an ulp in about
    one argument in ten). JAX contracts with float32 accumulation, so it
    has no float64 twin. These tolerances hold at errors estimates of a few
    units; far past them (eest in the tens, dt = 0.3 and more here) the
    plain sweep itself, bitwise the schedule on one column block, leaves
    them."""
    c = _case(B)
    parts = jmlp._split_params({"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }})
    t, dt = STEPS[step]
    outs, (ks, hs) = jmlp.make_normed_algebra_fwd_res(RTOL, ATOL)(
        jnp.float32(t), jnp.float32(dt), jnp.asarray(c["y"]), jnp.asarray(c["k1"]), parts)
    want = [*outs, *list(ks)[1:], *hs]
    _, solve = _run(c, torch.float32, step, col_blocks)
    for name, a, b in zip(NAMES, solve, want):
        rtol = 1e-4 if name.endswith("_ssq") else 2e-5
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=5e-7,
                                   err_msg=name)


# the flagship, the card tests' and chip_smoke.py's MLPDynamics shapes, and
# edge batches
PLAN_SHAPES = [(512, 784, 100), (1, 40, 24), (13, 40, 24), (64, 40, 24), (96, 200, 48),
               (256, 64, 32), (1040, 64, 32), (8, 16, 12), (5, 8, 5), (2048, 784, 100)]


def _k3_covers_once(plan, B, D, H):
    """Every (row, d) of the batch in exactly one of K3's tiles over the
    row chunks (``walk_tile``), and every (row, h) of the hidden layer
    reduced by exactly one block each stage: the block of its row block
    whose column block is the row's index modulo the column blocks
    (``solve_reduce``)."""
    elems = np.zeros((B, D), np.int64)
    hidden = np.zeros((B, H), np.int64)
    for chunk in range(plan.chunks):
        for blk in range(plan.tiles):
            rb, db = divmod(blk, plan.col_blocks)
            row0, d0 = (chunk * plan.row_blocks + rb) * plan.rows, db * plan.cols
            rows = max(0, min(plan.rows, B - row0))
            cols = max(0, min(plan.cols, D - d0))
            assert cols >= 1
            elems[row0:row0 + rows, d0:d0 + cols] += 1
            for r in range(db, rows, plan.col_blocks):
                hidden[row0 + r] += 1
    return (elems == 1).all() and (hidden == 1).all()


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_k3_plan_fits_within_the_walks_shared_memory(shape):
    """K3 runs on the walk's plan, and K4's replay runs K3's stages in the
    walk's shared memory: K3's lies below the walk's, so it never decides
    the plan, and within the card's; its tiles and its reduction cover
    every element once."""
    B, D_, H_ = shape
    plan = ws.walk_plan(B, D_, H_, 132)
    assert ws.solve_smem_bytes(plan.rows, plan.cols, H_) < plan.smem_bytes <= ws.SMEM_LIMIT
    assert _k3_covers_once(plan, B, D_, H_)


@pytest.mark.parametrize("sms", [4, 8, 33])
def test_k3_plan_solves_in_row_chunks_on_a_small_card(sms):
    """With fewer multiprocessors than tiles each trial step is solved in
    row chunks, every element and hidden row still once."""
    plan = ws.walk_plan(512, 784, 100, sms)
    assert plan.tiles <= sms and plan.chunks > 1
    assert _k3_covers_once(plan, 512, 784, 100)


def test_k3_smem_at_the_flagship():
    """32 x 100 tiles, 141,920 bytes: 9 floats of state an element (y,
    k1..k7, the stage input), the row block's hidden rows, the slab ring."""
    assert ws.walk_plan(512, 784, 100, 132)[:5] == (32, 100, 16, 8, 1)
    assert ws.solve_smem_bytes(32, 100, 100) == 4 * (32 * (8 * 100 + 104 + 104)
                                                     + 4 * 8 * 100 + 24) == 141_920
