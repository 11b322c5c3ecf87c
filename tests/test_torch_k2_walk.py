"""K2, the normed Tsit5 step's backward (``csrc/mlp_step_walk.cuh`` with the
normed seeds), on the CPU: one launch in the kernel's own schedule
(``whole_solve.plain_normed_walk_step``: the replay of the six stages in
K3's schedule, K4's seed phase with the rows' cotangents of y_new and k7 and
the three norm sums', then the walk's six reverse stages, phase A's partials
of ``cp2_i W2`` summed over column blocks in block order) against the plain
backward ``fused_mlp._normed_bwd_math`` and against the JAX package's K2,
``pallas_mlp._normed_pallas_bwd`` (run in interpret mode as the JAX
package's own tests run it on the CPU).

Both packages get the same numpy arrays from a seeded generator. The plans:
the card's (``walk_plan`` on 132 multiprocessors), three column blocks over
a ragged D (the last block narrower), a card of 8 multiprocessors (row
chunks) and the flagship's 32 x 100 tiles at 512x784x100 (float64 and
float32 only); the tolerances 1e-4 and the flagship's 1.4e-8, where the
norm seeds scale as 1/(atol + |y| rtol)^2. The kernel itself runs only on
the card: ``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phases 2-4.
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

T = 0.3
NAMES = ["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"]
# the norm sums' cotangents (err_ssq, num_ssq, den_ssq), chip_smoke.py phase 2's
NORM_CTS = (0.7, 1.3, -0.4)
T_SLACK = 2.0 ** -24  # float32's unit roundoff


def _case(B, D, H, seed=0):
    """Leaves at LeCun's scale, y, a random k1 (the embedded error far above
    its float32 floor) and the rows' cotangents of y_new and k7."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        W1=f32(rng.normal(size=(H, D + 1)) / np.sqrt(D + 1)),
        b1=f32(rng.normal(size=H) * 0.1),
        W2=f32(rng.normal(size=(D, H + 1)) / np.sqrt(H + 1)),
        b2=f32(rng.normal(size=D) * 0.1),
        y=f32(rng.normal(size=(B, D)) * 0.5),
        k1=f32(rng.normal(size=(B, D)) * 0.3),
        rows=[f32(rng.normal(size=(B, D))) for _ in range(2)],
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


def _cts(c, seeds, tt):
    """The five cotangents: the rows' and the norm sums' (``seeds`` "both"),
    the rows' alone, or the norm sums' alone."""
    rows = [tt(r) for r in c["rows"]]
    if seeds == "norms":
        rows = [torch.zeros_like(r) for r in rows]
    norms = (0.0,) * 3 if seeds == "rows" else NORM_CTS
    return [*rows, *(tt(v) for v in norms)]


def _run(c, dtype, dt, tol, plan, seeds="both"):
    """The plain backward and K2's schedule on the same inputs, each as
    ``(ct_t, ct_dt, ct_y, ct_k1, cW1, cb1, cW2, cb2)``; the schedule's
    weight cotangents from its rows by the plain contraction. Third, the
    sum of the magnitudes of ct_t's terms (the stages' ``ct_pre2 w2t`` and
    ``ct_pre1 w1t``)."""
    tt = lambda a: torch.tensor(a, dtype=dtype)
    leaves = [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]
    y, k1, t, dt_ = tt(c["y"]), tt(c["k1"]), tt(T), tt(dt)
    cts = _cts(c, seeds, tt)
    plain = fm._normed_bwd_math(t, dt_, y, k1, fm._split_params(*leaves), cts, tol, tol)
    walk = ws.plain_normed_walk_step(t, dt_, y, k1, leaves, cts, tol, tol, plan)
    cp2, _, cp1, _ = walk[4]
    t_terms = ((cp2.abs() @ leaves[2][:, -1].abs()).sum()
               + (cp1.abs() @ leaves[0][:, -1].abs()).sum()).item()
    return ([*plain[:4], *plain[4]], [*walk[:4], *wc.weight_cotangents_plain(*walk[4])],
            t_terms)


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


# (shape, plan): small shapes on every plan, a row-chunked one, the flagship
CASES = [((8, 16, 12), "card"), ((8, 16, 12), "cols3"), ((13, 40, 24), "card"),
         ((13, 40, 24), "cols3"), ((300, 40, 24), "sms8"), ((96, 200, 48), "card"),
         ((512, 784, 100), "card")]


@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape, kind", CASES)
def test_k2_schedule_is_the_plain_backward_in_float64(shape, kind, dt, tol):
    """The same function summed in another order: every output within
    1e-12 (relative Frobenius) in float64; ct_t, a sum of time terms that
    cancel (at 8x16x12 and dt 0.05 to 1/60000 of their magnitudes), within
    1e-12 of its terms' magnitudes."""
    plain, walk, t_terms = _run(_case(*shape), torch.float64, dt, tol, _plan(*shape, kind))
    assert abs(walk[0] - plain[0]).item() <= 1e-12 * t_terms
    for name, a, b in zip(NAMES[1:], walk[1:], plain[1:]):
        assert _rel(a, b) <= 1e-12, (name, _rel(a, b))


@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape, kind", CASES)
def test_k2_schedule_float32_within_plain_distance_from_float64(shape, kind, dt, tol):
    """In float32 the norm seeds amplify the stages' rounding: each output
    of the schedule lies from the float64 result within 3 times the float32
    plain backward's distance, plus 1e-6 (the bound chip_smoke.py phase 2
    holds K2 to). ct_t, whose terms cancel to 1/26000 of their magnitudes
    (300x40x24 at dt 0.3 and 1.4e-8), carries float32 rounding of those
    magnitudes, which either order of summation may cancel by chance: its
    slack is float32's unit roundoff times its terms' magnitudes."""
    c, plan = _case(*shape), _plan(*shape, kind)
    exact, _, t_terms = _run(c, torch.float64, dt, tol, plan)
    plain, walk, _ = _run(c, torch.float32, dt, tol, plan)
    d = lambda u: abs(u.double() - exact[0]).item()
    assert d(walk[0]) <= 3 * d(plain[0]) + T_SLACK * t_terms, (d(walk[0]), d(plain[0]))
    for name, a, b, x in zip(NAMES[1:], walk[1:], plain[1:], exact[1:]):
        assert _rel(a, x) <= 3 * _rel(b, x) + 1e-6, (name, _rel(a, x), _rel(b, x))


# the JAX package's tolerances: with the row cotangents alone that of
# test_torch_k14_walk.py's comparison with JAX's K14; with the norm sums',
# whose seeds multiply by 1/(atol + |y| rtol), that of
# test_torch_fused_mlp.py (tests/test_pallas_fused.py:180-188)
JAX_TOLS = {"rows": (2e-4, 1e-5), "norms": (2e-2, 5e-4)}


@pytest.mark.parametrize("seeds", ["rows", "norms"])
@pytest.mark.parametrize("shape, kind", [((6, 10, 7), "card"), ((13, 40, 24), "cols3"),
                                         ((13, 40, 24), "card")])
def test_k2_schedule_matches_jax_k2(shape, kind, seeds):
    """Against the JAX package's K2, ``_normed_pallas_bwd`` (interpret mode),
    at rtol=atol=1e-4 on the same cotangents, seeded by the rows alone and by
    the norm sums alone."""
    c = _case(*shape)
    params = {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}
    dt, tol = 0.07, 1e-4
    cts = tuple(jnp.asarray(x.numpy()) for x in _cts(c, seeds, lambda a: torch.tensor(a)))
    ct_t, ct_dt, ct_y, ct_k1, (cw1x, cw1t, cb1, cw2h, cw2t, cb2) = jmlp._normed_pallas_bwd(
        jnp.float32(T), jnp.float32(dt), jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
        jmlp._split_params(params), cts, tol, tol)
    want = [np.asarray(ct_t), np.asarray(ct_dt), np.asarray(ct_y), np.asarray(ct_k1),
            np.concatenate([np.asarray(cw1x), np.asarray(cw1t)], 0).T,
            np.asarray(cb1).reshape(-1),
            np.concatenate([np.asarray(cw2h), np.asarray(cw2t)], 0).T,
            np.asarray(cb2).reshape(-1)]
    _, walk, _ = _run(c, torch.float32, dt, tol, _plan(*shape, kind), seeds)
    rtol, atol = JAX_TOLS[seeds]
    for name, a, b in zip(NAMES, walk, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol, err_msg=name)
