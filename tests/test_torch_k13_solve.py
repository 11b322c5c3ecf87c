"""K13, the tuple Tsit5 step (``csrc/mlp_step_solve.cuh``), on the CPU: one
launch in the kernel's own schedule (``whole_solve.plain_tuple_solve_step``:
K3's six stages on the walk's tile plan, phase A's partials of ``y_i W1x^T``
summed over column blocks in block order, then each tile's rows ``(y_new,
k7, err, k6, g6)``) against the plain step ``fused_mlp._reference_sweep`` and
against the JAX package's K13, ``pallas_mlp._pallas_sweep`` (run in
interpret mode, as the JAX package's own tests run it on the CPU).

Both packages get the same numpy arrays from a seeded generator. The plans:
the card's (``walk_plan`` on 132 multiprocessors), three column blocks over
a ragged D (the last block narrower), a card of 8 multiprocessors (row
chunks) and the flagship's 32 x 100 tiles at 512x784x100 (float64 and
float32 only). The kernel itself runs only on the card:
``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phases 25-27.
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
NAMES = ["y_new", "k7", "err", "k6", "g6"]


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


def _run(c, dtype, t, dt, plan):
    """The plain step and K13's schedule on the same inputs, each as ``(y_new,
    k7, err, k6, g6)``."""
    tt = lambda a: torch.tensor(a, dtype=dtype)
    leaves = [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]
    y, k1, t_, dt_ = tt(c["y"]), tt(c["k1"]), tt(t), tt(dt)
    plain = fm._reference_sweep(t_, dt_, y, k1, fm._split_params(*leaves))
    return plain, ws.plain_tuple_solve_step(t_, dt_, y, k1, leaves, plan)


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


# (shape, plan): small shapes on every plan, a row-chunked one, the flagship
CASES = [((8, 16, 12), "card"), ((8, 16, 12), "cols3"), ((13, 40, 24), "card"),
         ((13, 40, 24), "cols3"), ((300, 40, 24), "sms8"), ((96, 200, 48), "card"),
         ((512, 784, 100), "card")]


def test_plans_are_those_named():
    """The plans the cases name: several column blocks with a narrower last
    one, row chunks, and the flagship's 128 tiles of 32 x 100."""
    p = _plan(13, 40, 24, "cols3")
    assert p.col_blocks == 3 and 40 - (p.col_blocks - 1) * p.cols < p.cols
    assert _plan(300, 40, 24, "sms8").chunks == 2
    assert _plan(96, 200, 48, "card").col_blocks == 7
    assert _plan(512, 784, 100, "card") == ws.WalkPlan(32, 100, 16, 8, 1, 206_464)


@pytest.mark.parametrize("shape, kind", CASES)
def test_plan_tiles_cover_the_batch_once(shape, kind):
    """The kernel's tiles (``walk_tile``: block ``b`` of chunk ``k`` at row
    block ``b // ndb``, column block ``b % ndb``, clipped to the batch) over
    every row chunk cover each element of the batch exactly once."""
    B, D, _ = shape
    p = _plan(*shape, kind)
    seen = np.zeros((B, D), np.int64)
    for chunk in range(p.chunks):
        for block in range(p.tiles):
            rb, db = divmod(block, p.col_blocks)
            row0 = (chunk * p.row_blocks + rb) * p.rows
            d0 = db * p.cols
            seen[row0:min(B, row0 + p.rows), d0:min(D, d0 + p.cols)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape, kind", CASES)
def test_k13_schedule_is_the_plain_step_in_float64(shape, kind, dt):
    """The same function summed in another order: every row within 1e-12
    (relative Frobenius) in float64."""
    plain, solve = _run(_case(*shape), torch.float64, T, dt, _plan(*shape, kind))
    for name, a, b in zip(NAMES, solve, plain):
        assert _rel(a, b) <= 1e-12, (name, _rel(a, b))


@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape, kind", CASES)
def test_k13_schedule_float32_within_plain_distance_from_float64(shape, kind, dt):
    """In float32 each row of the schedule lies from the float64 result
    within 3 times the float32 plain step's distance, plus 1e-7 (the bound
    chip_smoke.py phase 25 holds K13 to)."""
    c, plan = _case(*shape), _plan(*shape, kind)
    _, exact = _run(c, torch.float64, T, dt, plan)
    plain, solve = _run(c, torch.float32, T, dt, plan)
    for name, a, b, x in zip(NAMES, solve, plain, exact):
        assert _rel(a, x) <= 3 * _rel(b, x) + 1e-7, (name, _rel(a, x), _rel(b, x))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape, kind", [((6, 10, 7), "card"), ((13, 40, 24), "cols3"),
                                         ((13, 40, 24), "card"), ((384, 40, 24), "sms8")])
def test_k13_schedule_matches_jax_k13(shape, kind, seed):
    """Against the JAX package's K13, ``pallas_mlp._pallas_sweep`` in
    interpret mode (a batch its 8-row blocks divide, 384 in two row chunks
    on 8 multiprocessors), at the tolerance of
    ``test_torch_stage_sweep.py::test_reference_sweep_matches_jax_stage_sweep``
    (rtol 2e-5, atol 1e-6)."""
    c = _case(*shape, seed)
    params = {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}
    want = jmlp._pallas_sweep(jnp.float32(T), jnp.float32(0.07), jnp.asarray(c["y"]),
                              jnp.asarray(c["k1"]), jmlp._split_params(params))
    _, solve = _run(c, torch.float32, T, 0.07, _plan(*shape, kind))
    for name, a, b in zip(NAMES, solve, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-6,
                                   err_msg=name)
