"""K12, the lane-wise Tsit5 step's backward (``csrc/mlp_step_walk.cuh`` with
``LaneSeed``), on the CPU: one launch in the kernel's own schedule
(``whole_solve.plain_lanes_walk_step``: the replay of the six stages in K3's
schedule at every row's own ``(t, dt)``, the seed phase with the five row
cotangents, then the walk's six reverse stages, phase A's partials of
``cp2_i W2`` summed over column blocks in block order, each row's ``ct_t``
and ``ct_dt`` over its own terms) against the plain backward
``fused_mlp_lanes._lanes_bwd_math`` and against the JAX package's K12,
``jax.vjp`` of ``pallas_mlp._fused_step_lanes`` (its Pallas backward, run in
interpret mode as the JAX package's own tests run it on the CPU).

Both packages get the same numpy arrays from a seeded generator: per-row t
over [0, 1.2] and dt over [1e-3, 0.3], every fifth lane finished (dt = 0).
The plans: the card's (``walk_plan`` on 132 multiprocessors with K12's
state), three column blocks over a ragged D (the last block narrower), a
card of 8 multiprocessors (row chunks) and the flagship's 32 x 100 tiles at
512x784x100 (float64 and float32 only). The kernel itself runs only on the
card: ``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phases 22-24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import fused_mlp_lanes as fl
from regneuralde_tpu_torch.ops import weight_cotangents as wc
from regneuralde_tpu_torch.ops import whole_solve as ws

torch.set_num_threads(1)

NAMES = ["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"]
T_SLACK = 2.0 ** -24  # float32's unit roundoff


def _case(B, D, H, seed=0, dt_max=0.3):
    """Leaves at LeCun's scale, y, a random k1, per-row (t, dt) with every
    fifth lane finished, and the five row cotangents."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    dt = f32(rng.uniform(1e-3, dt_max, B))
    dt[::5] = 0.0
    return dict(
        W1=f32(rng.normal(size=(H, D + 1)) / np.sqrt(D + 1)),
        b1=f32(rng.normal(size=H) * 0.1),
        W2=f32(rng.normal(size=(D, H + 1)) / np.sqrt(H + 1)),
        b2=f32(rng.normal(size=D) * 0.1),
        y=f32(rng.normal(size=(B, D)) * 0.5),
        k1=f32(rng.normal(size=(B, D)) * 0.3),
        t=f32(rng.uniform(0.0, 1.2, B)),
        dt=dt,
        cts=[f32(rng.normal(size=(B, D))) for _ in range(5)],
    )


def _plan(B, D, H, kind):
    """The tile plan of ``kind`` with K12's state: the card's, three column
    blocks of ``ceil(D / 3)`` rounded to the column alignment (the last
    narrower), or a card of 8 multiprocessors."""
    if kind == "card":
        return ws.walk_plan(B, D, H, 132, state=ws.LANE_STATE)
    if kind == "sms8":
        return ws.walk_plan(B, D, H, 8, state=ws.LANE_STATE)
    C = -(-(-(-D // 3)) // ws.WALK_COL_ALIGN) * ws.WALK_COL_ALIGN
    return ws.WalkPlan(16, C, -(-B // 16), -(-D // C), 1, 0)


def _run(c, dtype, plan):
    """The plain backward and K12's schedule on the same inputs, each as
    ``(ct_t, ct_dt, ct_y, ct_k1, cW1, cb1, cW2, cb2)``; the schedule's weight
    cotangents from its rows by the plain contraction. Third, each row's sum
    of the magnitudes of its ct_t terms (the stages' ``ct_pre2 w2t`` and
    ``ct_pre1 w1t``)."""
    tt = lambda a: torch.tensor(a, dtype=dtype)
    leaves = [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]
    y, k1, t, dt = tt(c["y"]), tt(c["k1"]), tt(c["t"]), tt(c["dt"])
    cts = [tt(x) for x in c["cts"]]
    plain = fl._lanes_bwd_math(t[:, None], dt[:, None], y, k1, fm._split_params(*leaves), cts)
    walk = ws.plain_lanes_walk_step(t, dt, y, k1, leaves, cts, plan)
    B = y.shape[0]
    cp2, _, cp1, _ = walk[4]
    t_terms = ((cp2.abs() @ leaves[2][:, -1].abs()).reshape(6, B).sum(0)
               + (cp1.abs() @ leaves[0][:, -1].abs()).reshape(6, B).sum(0))
    return ([*plain[:4], *plain[4]], [*walk[:4], *wc.weight_cotangents_plain(*walk[4])],
            t_terms.double())


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
    one, row chunks, and the flagship's 128 tiles of 32 x 100 with K12's
    per-element ct_dt shares and its tile's rows (R C + 5 R floats more
    shared memory than K14's)."""
    p = _plan(13, 40, 24, "cols3")
    assert p.col_blocks == 3 and 40 - (p.col_blocks - 1) * p.cols < p.cols
    assert _plan(300, 40, 24, "sms8").chunks == 2
    assert _plan(96, 200, 48, "card").col_blocks == 7
    assert _plan(512, 784, 100, "card") == ws.WalkPlan(32, 100, 16, 8, 1,
                                                       206_464 + 4 * (32 * 100 + 5 * 32))
    assert ws.walk_smem_bytes(32, 100, 100, ws.LANE_STATE) <= ws.SMEM_LIMIT


def test_cases_hold_finished_lanes_and_spread_steps():
    """Every case has finished lanes (dt = 0) and steps over [1e-3, 0.3]."""
    c = _case(300, 40, 24)
    assert (c["dt"] == 0).sum() == 60
    live = c["dt"][c["dt"] > 0]
    assert live.min() < 0.01 and live.max() > 0.29


@pytest.mark.parametrize("shape, kind", CASES)
def test_k12_schedule_is_the_plain_backward_in_float64(shape, kind):
    """The same function summed in another order: every output within
    1e-12 (relative Frobenius) in float64, finished lanes included; ct_t
    row by row within 1e-12 of its terms' magnitudes."""
    plain, walk, t_terms = _run(_case(*shape), torch.float64, _plan(*shape, kind))
    assert ((walk[0] - plain[0]).abs() <= 1e-12 * t_terms).all()
    for name, a, b in zip(NAMES, walk, plain):
        assert _rel(a, b) <= 1e-12, (name, _rel(a, b))


def test_k12_schedule_on_finished_lanes_is_the_plain_backward():
    """A batch of finished lanes only (dt = 0: the stage inputs are y, the
    stage times t): every output within 1e-12 of the plain backward in
    float64, ct_y's and ct_k1's rows finite."""
    c = _case(13, 40, 24)
    c["dt"][:] = 0.0
    plain, walk, _ = _run(c, torch.float64, _plan(13, 40, 24, "cols3"))
    for name, a, b in zip(NAMES, walk, plain):
        assert torch.isfinite(a).all() and _rel(a, b) <= 1e-12, (name, _rel(a, b))


@pytest.mark.parametrize("shape, kind", CASES)
def test_k12_schedule_float32_within_plain_distance_from_float64(shape, kind):
    """In float32 each output of the schedule lies from the float64 result
    within 3 times the float32 plain backward's distance, plus 1e-6 (the
    bound chip_smoke.py phase 22 holds K12 to). ct_t, whose rows are sums
    of time terms that cancel (at 512x784x100 one row to 1/1,500,000 of its
    terms' magnitudes), carries float32 rounding of those magnitudes, which
    either order of summation may cancel by chance: its slack is float32's
    unit roundoff times its terms' magnitudes (the norm over the rows; as
    test_torch_k2_walk.py holds K2's scalar ct_t)."""
    c, plan = _case(*shape), _plan(*shape, kind)
    exact, _, t_terms = _run(c, torch.float64, plan)
    plain, walk, _ = _run(c, torch.float32, plan)
    d = lambda u: torch.linalg.vector_norm(u.double() - exact[0]).item()
    slack = T_SLACK * torch.linalg.vector_norm(t_terms).item()
    assert d(walk[0]) <= 3 * d(plain[0]) + slack, (d(walk[0]), d(plain[0]), slack)
    for name, a, b, x in zip(NAMES[1:], walk[1:], plain[1:], exact[1:]):
        assert _rel(a, x) <= 3 * _rel(b, x) + 1e-6, (name, _rel(a, x), _rel(b, x))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape, kind", [((6, 10, 7), "card"), ((13, 40, 24), "cols3"),
                                         ((13, 40, 24), "card")])
def test_k12_schedule_matches_jax_k12(shape, kind, seed):
    """Against ``jax.vjp`` of the JAX package's ``_fused_step_lanes`` (its
    K12, interpret mode) on the same per-row times and five row cotangents,
    at the tolerance of ``test_torch_per_sample.py``'s K12 comparison (rtol
    2e-3, atol 1e-5)."""
    c = _case(*shape, seed)
    params = {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}
    _, vjp = jax.vjp(jmlp._fused_step_lanes, jnp.asarray(c["t"])[:, None],
                     jnp.asarray(c["dt"])[:, None], jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
                     jmlp._split_params(params))
    ct_t, ct_dt, ct_y, ct_k1, (cw1x, cw1t, cb1, cw2h, cw2t, cb2) = vjp(
        tuple(jnp.asarray(x) for x in c["cts"]))
    want = [np.asarray(ct_t)[:, 0], np.asarray(ct_dt)[:, 0], np.asarray(ct_y),
            np.asarray(ct_k1), np.concatenate([np.asarray(cw1x), np.asarray(cw1t)], 0).T,
            np.asarray(cb1).reshape(-1),
            np.concatenate([np.asarray(cw2h), np.asarray(cw2t)], 0).T,
            np.asarray(cb2).reshape(-1)]
    _, walk, _ = _run(c, torch.float32, _plan(*shape, kind))
    for name, a, b in zip(NAMES, walk, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=1e-5, err_msg=name)


def test_k12_wrapper_takes_the_plain_version_on_the_cpu():
    """``sweep_lanes_bwd`` on CPU tensors is the plain backward, counts no
    launch, and gives (B,) ct_t and ct_dt."""
    c = _case(13, 40, 24)
    tt = torch.tensor
    leaves = [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]
    args = (tt(c["t"]), tt(c["dt"]), tt(c["y"]), tt(c["k1"]))
    cts = [tt(x) for x in c["cts"]]
    fl.reset_launches()
    got = fl.sweep_lanes_bwd(*args, leaves, cts)
    want = fl._lanes_bwd_math(args[0][:, None], args[1][:, None], args[2], args[3],
                              fm._split_params(*leaves), cts)
    assert got[0].shape == got[1].shape == (13,)
    assert all(torch.equal(a, b) for a, b in zip([*got[:4], *got[4]], [*want[:4], *want[4]]))
    assert fl.LAUNCHES == {"mlp_lanes_tsit5_fwd": 0, "mlp_lanes_tsit5_bwd": 0}
