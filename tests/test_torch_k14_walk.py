"""K14, the tuple Tsit5 step's backward (``csrc/mlp_step_walk.cuh``), on the
CPU: one launch in the kernel's own schedule
(``whole_solve.plain_tuple_walk_step``: the replay of the six stages in K3's
schedule, the seed phase with the five row cotangents, then the walk's six
reverse stages, phase A's partials of ``cp2_i W2`` summed over column blocks
in block order) against the plain backward ``fused_mlp._bwd_math`` and
against the JAX package's K14, ``jax.vjp`` of ``pallas_mlp._fused_step``
(its Pallas backward, run in interpret mode as the JAX package's own tests
run it on the CPU).

Both packages get the same numpy arrays from a seeded generator. The plans:
the card's (``walk_plan`` on 132 multiprocessors), three column blocks over
a ragged D (the last block narrower), a card of 8 multiprocessors (row
chunks) and the flagship's 32 x 100 tiles at 512x784x100 (float64 and
float32 only). The kernel itself runs only on the card:
``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phases 25-27.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import weight_cotangents as wc
from regneuralde_tpu_torch.ops import whole_solve as ws

torch.set_num_threads(1)

T = 0.3
NAMES = ["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"]


def _case(B, D, H, seed=0):
    """Leaves at LeCun's scale, y, k1 and the five row cotangents."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        W1=f32(rng.normal(size=(H, D + 1)) / np.sqrt(D + 1)),
        b1=f32(rng.normal(size=H) * 0.1),
        W2=f32(rng.normal(size=(D, H + 1)) / np.sqrt(H + 1)),
        b2=f32(rng.normal(size=D) * 0.1),
        y=f32(rng.normal(size=(B, D)) * 0.5),
        k1=f32(rng.normal(size=(B, D)) * 0.3),
        cts=[f32(rng.normal(size=(B, D))) for _ in range(5)],
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


def _run(c, dtype, dt, plan):
    """The plain backward and K14's schedule on the same inputs, each as
    ``(ct_t, ct_dt, ct_y, ct_k1, cW1, cb1, cW2, cb2)``; the schedule's
    weight cotangents from its rows by the plain contraction."""
    tt = lambda a: torch.tensor(a, dtype=dtype)
    leaves = [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]
    y, k1, t, dt_ = tt(c["y"]), tt(c["k1"]), tt(T), tt(dt)
    cts = [tt(x) for x in c["cts"]]
    plain = fm._bwd_math(t, dt_, y, k1, fm._split_params(*leaves), cts)
    walk = ws.plain_tuple_walk_step(t, dt_, y, k1, leaves, cts, plan)
    return ([*plain[:4], *plain[4]], [*walk[:4], *wc.weight_cotangents_plain(*walk[4])])


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


@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape, kind", CASES)
def test_k14_schedule_is_the_plain_backward_in_float64(shape, kind, dt):
    """The same function summed in another order: every output within
    1e-12 (relative Frobenius) in float64."""
    plain, walk = _run(_case(*shape), torch.float64, dt, _plan(*shape, kind))
    for name, a, b in zip(NAMES, walk, plain):
        assert _rel(a, b) <= 1e-12, (name, _rel(a, b))


@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape, kind", CASES)
def test_k14_schedule_float32_within_plain_distance_from_float64(shape, kind, dt):
    """In float32 each output of the schedule lies from the float64 result
    within 3 times the float32 plain backward's distance, plus 1e-6 (the
    bound chip_smoke.py phase 25 holds K14 to)."""
    c, plan = _case(*shape), _plan(*shape, kind)
    exact, _ = _run(c, torch.float64, dt, plan)
    plain, walk = _run(c, torch.float32, dt, plan)
    for name, a, b, x in zip(NAMES, walk, plain, exact):
        assert _rel(a, x) <= 3 * _rel(b, x) + 1e-6, (name, _rel(a, x), _rel(b, x))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape, kind", [((6, 10, 7), "card"), ((13, 40, 24), "cols3"),
                                         ((13, 40, 24), "card")])
def test_k14_schedule_matches_jax_k14(shape, kind, seed):
    """Against ``jax.vjp`` of the JAX package's ``_fused_step`` (its K14,
    interpret mode) on the same five row cotangents, at the tolerance of
    ``test_torch_stage_sweep.py::test_bwd_math_matches_jax_vjp`` (rtol 2e-4,
    atol 1e-5)."""
    c = _case(*shape, seed)
    params = {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}
    _, vjp = jax.vjp(jmlp._fused_step, jnp.float32(T), jnp.float32(0.07),
                     jnp.asarray(c["y"]), jnp.asarray(c["k1"]), jmlp._split_params(params))
    ct_t, ct_dt, ct_y, ct_k1, (cw1x, cw1t, cb1, cw2h, cw2t, cb2) = vjp(
        tuple(jnp.asarray(x) for x in c["cts"]))
    want = [np.asarray(ct_t), np.asarray(ct_dt), np.asarray(ct_y), np.asarray(ct_k1),
            np.concatenate([np.asarray(cw1x), np.asarray(cw1t)], 0).T,
            np.asarray(cb1).reshape(-1),
            np.concatenate([np.asarray(cw2h), np.asarray(cw2t)], 0).T,
            np.asarray(cb2).reshape(-1)]
    _, walk = _run(c, torch.float32, 0.07, _plan(*shape, kind))
    for name, a, b in zip(NAMES, walk, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=1e-5, err_msg=name)
