"""K1, the normed Tsit5 step (``csrc/mlp_step_solve.cuh`` with ``NormedEnd``),
on the CPU: one launch in the kernel's own schedule
(``whole_solve.plain_normed_solve_step``: K3's six stages on the walk's tile
plan, phase A's partials of ``y_i W1x^T`` summed over column blocks in block
order, then each tile's rows ``y_new`` and ``k7`` and its three norm sums,
summed in the kernel's order: each thread's terms one by one, the block's
by shuffle trees and warps in order, the tiles' slots in tile order)
against the plain step ``fused_mlp._reference_normed_sweep`` and against the
JAX package's K1, ``pallas_mlp._normed_pallas_fwd`` (run in interpret mode,
as the JAX package's own tests run it on the CPU).

Both packages get the same numpy arrays from a seeded generator. The plans
are ``test_torch_k13_solve.py``'s: the card's (``walk_plan`` on 132
multiprocessors), three column blocks over a ragged D, a card of 8
multiprocessors (row chunks) and the flagship's 32 x 100 tiles at
512x784x100 (float64 and float32 only). The kernel itself runs only on the
card: ``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phase 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import whole_solve as ws

torch.set_num_threads(1)

T = 0.3
NAMES = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]


def _case(B, D, H, seed=0):
    """Leaves at LeCun's scale, y and k1."""
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


def _plan(B, D, H, kind):
    """The tile plan of ``kind``: the card's, three column blocks of
    ``ceil(D / 3)`` rounded to the column alignment (the last narrower), or
    a card of 8 multiprocessors."""
    if kind == "card":
        return ws.walk_plan(B, D, H, 132)
    if kind == "sms8":
        return ws.walk_plan(B, D, H, 8)
    C = -(-(-(-D // 3)) // ws.WALK_COL_ALIGN) * ws.WALK_COL_ALIGN
    return ws.WalkPlan(16, C, -(-B // 16), -(-D // C), 1, 0)


def _inputs(c, dtype, t, dt):
    tt = lambda a: torch.tensor(a, dtype=dtype)
    return tt(t), tt(dt), tt(c["y"]), tt(c["k1"]), [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]


def _run(c, dtype, t, dt, plan, tol):
    """The plain step and K1's schedule on the same inputs, each as ``(y_new,
    k7, err_ssq, num_ssq, den_ssq)``."""
    t_, dt_, y, k1, leaves = _inputs(c, dtype, t, dt)
    plain = fm._reference_normed_sweep(t_, dt_, y, k1, fm._split_params(*leaves), tol, tol)
    return plain, ws.plain_normed_solve_step(t_, dt_, y, k1, leaves, plan, tol, tol)


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


# (shape, plan): small shapes on every plan, a row-chunked one, the flagship
CASES = [((8, 16, 12), "card"), ((8, 16, 12), "cols3"), ((13, 40, 24), "card"),
         ((13, 40, 24), "cols3"), ((300, 40, 24), "sms8"), ((96, 200, 48), "card"),
         ((512, 784, 100), "card")]


@pytest.mark.parametrize("shape, kind", CASES)
def test_kernel_order_sums_take_every_element_once(shape, kind):
    """The kernel's order of summation (``_kernel_order_sums``) over every
    row chunk, tile and thread takes each element of the batch exactly once:
    integer terms, exact in float64, sum to their total, and ones to B x D."""
    B, D, _ = shape
    rng = np.random.default_rng(7)
    terms = torch.stack([torch.ones(B, D, dtype=torch.float64),
                         torch.tensor(rng.integers(0, 1000, size=(B, D)), dtype=torch.float64)])
    ones, ints = ws._kernel_order_sums(terms, _plan(*shape, kind))
    assert ones.item() == B * D
    assert ints.item() == terms[1].sum().item()


@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape, kind", CASES)
def test_k1_schedule_is_the_plain_step_in_float64(shape, kind, dt, tol):
    """The same function summed in another order: the rows and the three
    norm sums within 1e-12 (relative) in float64."""
    plain, solve = _run(_case(*shape), torch.float64, T, dt, _plan(*shape, kind), tol)
    for name, a, b in zip(NAMES, solve, plain):
        assert _rel(a, b) <= 1e-12, (name, _rel(a, b))


def _term_rows(c, dtype, dt, plan, tol, sweep):
    """The rows whose squares K1 sums, ``err / denom``, ``k7 - k6`` and
    ``y_new - g6``, from the tuple rows of ``sweep``: K13's schedule (K1's
    stages, bitwise) or the plain step."""
    t_, dt_, y, k1, leaves = _inputs(c, dtype, T, dt)
    if sweep == "schedule":
        y_new, k7, err, k6, g6 = ws.plain_tuple_solve_step(t_, dt_, y, k1, leaves, plan)
    else:
        y_new, k7, err, k6, g6 = fm._reference_sweep(t_, dt_, y, k1, fm._split_params(*leaves))
    return err / (tol + torch.maximum(y.abs(), y_new.abs()) * tol), k7 - k6, y_new - g6


def _chain(plan):
    """The most float32 operations a term of K1's sums goes through: its
    square, a thread's additions (the four rows of each 4-row group it takes,
    every row chunk), the warp's shuffle tree (5), the warps (8), a lane's
    tiles and the last shuffle tree (5)."""
    items = plan.cols * (plan.rows // 4)
    return 1 + 4 * -(-items // 256) * plan.chunks + 5 + 8 + -(-plan.tiles // 32) + 5


@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape, kind", CASES)
def test_k1_schedule_float32_within_plain_distance_from_float64(shape, kind, dt, tol):
    """In float32 the schedule's rows (y_new, k7, and the three rows whose
    squares it sums) lie from the float64 result within 3 times the float32
    plain step's distance, plus 1e-7 (the bound chip_smoke.py phase 25
    holds K13's rows to). A norm sum is one number whose float32 rounding
    lands by chance (the plain step's own distance reads 6e-9 to 1.4e-7 on
    these cases), so it is held to what rounding can do to it: a sum S of
    the squares of a row r, with r within e of float64 (relative Frobenius),
    taken with at most h roundings a term (``_chain``), lies within 2e + e^2
    + gamma_h (1 + e)^2 of S (gamma_h = h u / (1 - h u), u = 2^-24)."""
    c, plan = _case(*shape), _plan(*shape, kind)
    _, exact = _run(c, torch.float64, T, dt, plan, tol)
    plain, solve = _run(c, torch.float32, T, dt, plan, tol)
    for name, a, b, x in zip(NAMES[:2], solve, plain, exact):
        assert _rel(a, x) <= 3 * _rel(b, x) + 1e-7, (name, _rel(a, x), _rel(b, x))
    rows = _term_rows(c, torch.float32, dt, plan, tol, "schedule")
    plain_rows = _term_rows(c, torch.float32, dt, plan, tol, "plain")
    rows64 = _term_rows(c, torch.float64, dt, plan, tol, "schedule")
    hu = _chain(plan) * 2.0 ** -24
    for k, name in enumerate(NAMES[2:]):
        e = _rel(rows[k], rows64[k])
        assert e <= 3 * _rel(plain_rows[k], rows64[k]) + 1e-7, (name, "row", e)
        bound = 2 * e + e * e + hu / (1 - hu) * (1 + e) ** 2
        d = _rel(solve[2 + k], exact[2 + k])
        assert d <= bound, (name, d, bound)


@pytest.mark.parametrize("shape, kind", CASES)
def test_k1_schedule_rows_are_k13s(shape, kind):
    """K1's rows are K13's: ``y_new`` and ``k7`` of the normed schedule equal
    ``plain_tuple_solve_step``'s bitwise in float32 (one kernel, the same
    stages; only the tile end differs), so K2, which replays K13's stages,
    differentiates K1's."""
    c, plan = _case(*shape), _plan(*shape, kind)
    t, dt, y, k1, leaves = _inputs(c, torch.float32, T, 0.05)
    normed = ws.plain_normed_solve_step(t, dt, y, k1, leaves, plan, 1e-4, 1e-4)
    tup = ws.plain_tuple_solve_step(t, dt, y, k1, leaves, plan)
    assert torch.equal(normed[0], tup[0]) and torch.equal(normed[1], tup[1])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape, kind", [((6, 10, 7), "card"), ((13, 40, 24), "cols3"),
                                         ((13, 40, 24), "card"), ((384, 40, 24), "sms8")])
def test_k1_schedule_matches_jax_k1(shape, kind, seed):
    """Against the JAX package's K1, ``pallas_mlp._normed_pallas_fwd`` in
    interpret mode (a batch its 8-row blocks divide or one whole-batch block,
    384 in two row chunks on 8 multiprocessors), at rtol=atol=1e-4: the rows
    at K13's test's tolerance (rtol 2e-5, atol 1e-6), the three norm sums at
    ``test_torch_fused_mlp.py::test_plain_forward_matches_jax_kernel_and_reference``'s
    (rtol 1e-4, atol 5e-7: err_ssq sums a fifth-order cancellation, which
    carries ATen's and XLA's exp's last-ulp differences relative to a small
    number)."""
    c = _case(*shape, seed)
    params = {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}
    want = jmlp._normed_pallas_fwd(jnp.float32(T), jnp.float32(0.07), jnp.asarray(c["y"]),
                                   jnp.asarray(c["k1"]), jmlp._split_params(params),
                                   1e-4, 1e-4)
    _, solve = _run(c, torch.float32, T, 0.07, _plan(*shape, kind), 1e-4)
    for name, a, b in zip(NAMES, solve, want):
        rtol, atol = (2e-5, 1e-6) if name in ("y_new", "k7") else (1e-4, 5e-7)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=name)
